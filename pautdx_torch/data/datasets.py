"""Signal-sequence datasets over JSON PAUT volumes (host-side, numpy).

The port's own copy of ``pautdx/data/datasets.py``, over the port's
``data/{volume,windowing,grammar}.py``:

- :class:`SignalSequences`: every beam of a volume windowed into
  sequences, materialized once as contiguous numpy arrays ``(num_seqs,
  L, S)`` (the whole dataset of this domain fits in host RAM);
- ``defect_focused``: the class-balancing filter;
- ``train_val_split`` and :class:`BatchIterator`, fixed-shape numpy
  batches (the tail dropped, or padded with a ``sample_mask``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from pautdx_torch.data import windowing
from pautdx_torch.data.volume import ParsedVolume, parse_json_volume


@dataclasses.dataclass
class SignalSequences:
    """Windowed signal sequences: signals (N,L,S), labels (N,L), positions
    (N,L,2). ``class_labels`` (N,L) carries multiclass ids (0 = Health,
    i+1 = label_names[i]) for the multiclass detectors; binary ``labels``
    stay the default contract."""

    signals: np.ndarray
    labels: np.ndarray
    positions: np.ndarray
    label_names: List[str] = dataclasses.field(default_factory=list)
    class_labels: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.signals.shape[0]

    def subset(self, idx) -> "SignalSequences":
        return SignalSequences(
            self.signals[idx], self.labels[idx], self.positions[idx],
            self.label_names,
            None if self.class_labels is None else self.class_labels[idx],
        )

    @property
    def num_classes(self) -> int:
        """Health + defect types (the reference's label_map contract)."""
        return len(self.label_names) + 1

    @staticmethod
    def concatenate(parts: Sequence["SignalSequences"]) -> "SignalSequences":
        parts = [p for p in parts if len(p)]
        if not parts:
            return SignalSequences(
                np.zeros((0, 0, 0), np.float32),
                np.zeros((0, 0), np.float32),
                np.zeros((0, 0, 2), np.float32),
            )
        names = sorted({n for p in parts for n in p.label_names})
        class_labels = None
        if all(p.class_labels is not None for p in parts):
            # re-map each part's ids onto the merged name list
            remapped = []
            for p in parts:
                lut = np.zeros(len(p.label_names) + 1, np.int32)
                for i, n in enumerate(p.label_names):
                    lut[i + 1] = names.index(n) + 1
                remapped.append(lut[p.class_labels])
            class_labels = np.concatenate(remapped)
        return SignalSequences(
            np.concatenate([p.signals for p in parts]),
            np.concatenate([p.labels for p in parts]),
            np.concatenate([p.positions for p in parts]),
            names,
            class_labels,
        )


def sequences_from_volume(vol: ParsedVolume, seq_len: int = 50,
                          overlap: bool = False) -> SignalSequences:
    """Window every beam of a parsed volume into fixed-length sequences.

    Binary labels (Health=0 / defect=1) and normalized defect (start, end)
    with the (0, 0) healthy fallback — `json_dataset.py:69-79`.
    """
    seqs, labs, poss, cls_names = [], [], [], []
    names = set()
    win_fn = windowing.overlapping_windows if overlap else windowing.chunked_windows
    for bk in vol.beam_keys:
        sig = vol.signals[bk]
        infos = vol.scan_infos[bk]
        n = sig.shape[0]
        for (a, b) in win_fn(n, seq_len):
            seqs.append(sig[a:b])
            labs.append([infos[j].binary_label for j in range(a, b)])
            poss.append([list(infos[j].position) for j in range(a, b)])
            cls_names.append([infos[j].label if infos[j].is_defect else None
                              for j in range(a, b)])
            for j in range(a, b):
                if infos[j].is_defect:
                    names.add(infos[j].label)
    if not seqs:
        return SignalSequences(
            np.zeros((0, seq_len, 0), np.float32),
            np.zeros((0, seq_len), np.float32),
            np.zeros((0, seq_len, 2), np.float32),
        )
    # drop sequences whose signal length disagrees with the majority
    # (the reference drops mixed-length windows, `json_dataset.py:131-141`)
    lens = [s.shape[1] for s in seqs]
    mode = max(set(lens), key=lens.count)
    keep = [i for i, l in enumerate(lens) if l == mode]
    sorted_names = sorted(names)
    name_to_id = {n: i + 1 for i, n in enumerate(sorted_names)}
    class_labels = np.asarray(
        [[name_to_id.get(c, 0) for c in cls_names[i]] for i in keep],
        np.int32)
    return SignalSequences(
        np.stack([seqs[i] for i in keep]).astype(np.float32),
        np.asarray([labs[i] for i in keep], np.float32),
        np.asarray([poss[i] for i in keep], np.float32),
        sorted_names,
        class_labels,
    )


def load_json_dir(json_dir: str, seq_len: int = 50,
                  overlap: bool = False) -> SignalSequences:
    """All ``*.json`` volumes in a directory -> one SignalSequences."""
    parts = []
    for fn in sorted(os.listdir(json_dir)):
        if not fn.endswith(".json"):
            continue
        try:
            vol = parse_json_volume(os.path.join(json_dir, fn))
        except Exception:
            continue  # reference skips unreadable files (`json_dataset.py:157-158`)
        parts.append(sequences_from_volume(vol, seq_len, overlap))
    return SignalSequences.concatenate(parts)


def defect_focused(ds: SignalSequences, min_defects: int = 1,
                   only_defective: bool = False) -> SignalSequences:
    """Class-balancing filter (`defect_focused_dataset.py:132-155`).

    Keeps every window containing >= ``min_defects`` defect signals; windows
    below the threshold are kept only while the kept-healthy count is less
    than the kept-defective count (or dropped entirely if
    ``only_defective``). Order-dependent by design, like the reference.
    """
    keep, n_def, n_healthy = [], 0, 0
    for i in range(len(ds)):
        d = float(ds.labels[i].sum())
        if d >= min_defects:
            keep.append(i)
            n_def += 1
        else:
            if only_defective or n_healthy >= n_def:
                continue
            keep.append(i)
            n_healthy += 1
    return ds.subset(np.asarray(keep, np.int64))


def train_val_split(ds: SignalSequences, val_fraction: float = 0.2,
                    seed: int = 42) -> Tuple[SignalSequences, SignalSequences]:
    """Seeded random split (`json_dataset.py:191-200`: split seeded 42)."""
    n = len(ds)
    perm = np.random.default_rng(seed).permutation(n)
    n_val = int(n * val_fraction)
    return ds.subset(perm[n_val:]), ds.subset(perm[:n_val])


class BatchIterator:
    """Shuffling batch iterator producing fixed-shape numpy batches.

    Drops the ragged tail batch when ``drop_remainder``; otherwise pads
    the tail by wrap-around, and evaluation sees every sample exactly once
    through the batch's ``sample_mask``. ``augment(batch, rng)``, where
    given, maps each batch.
    """

    def __init__(self, ds: SignalSequences, batch_size: int, *,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True,
                 augment=None):
        self.ds = ds
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.augment = augment
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        n = len(self.ds)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        self._epoch += 1
        bs = self.batch_size
        n_batches = len(self)
        for i in range(n_batches):
            idx = order[i * bs:(i + 1) * bs]
            mask = np.ones((bs,), np.float32)
            if idx.shape[0] < bs:  # padded tail (eval only)
                mask[idx.shape[0]:] = 0.0
                # np.resize tiles `order` as needed — order[:pad] alone
                # is short whenever the whole dataset is smaller than
                # one batch (then the arrays would disagree with mask)
                idx = np.concatenate(
                    [idx, np.resize(order, bs - idx.shape[0])])
            batch = {
                "signals": self.ds.signals[idx],
                "labels": self.ds.labels[idx],
                "positions": self.ds.positions[idx],
                "sample_mask": mask,
            }
            if self.ds.class_labels is not None:
                batch["class_labels"] = self.ds.class_labels[idx]
            if self.augment is not None:
                batch = self.augment(batch, self._rng)
            yield batch
