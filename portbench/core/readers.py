"""Readers of quantities that several per-layer metrics take, one metric a
family of cells: each metric moves its family's end-to-end metric, so one
quantity is one file a family, each naming its reader here."""

from __future__ import annotations

from portbench.core.peaks import PEAK_FLOP_PER_S


def host_ms(rec):
    """Host wall ms a batch inside the port's call (the harness's
    ``serve.call`` span around the entry's step)."""
    calls = rec.host_spans.get("serve.call", [])
    return 1e3 * sum(calls) / len(calls) if calls else None


def copy_ms(rec):
    """Device ms of the host-card copies (memcpy and memset events) a
    batch: the frames in and the answers out."""
    us = rec.copy_us()
    if not rec.batches or us <= 0:
        return None
    return us / 1e3 / rec.batches


def mfu(rec):
    """The whole served forward's share of the card's published peak in
    the configuration's precision: the model FLOPs of a frame (counted
    once over the reference, in the configuration's file) times the frames
    completed in the traced window, over the window on the host clock,
    over the peak."""
    flops = rec.config.get("flops", {}).get("per_frame")
    precision = rec.config.get("serve", {}).get("precision")
    if not flops or precision not in PEAK_FLOP_PER_S or not rec.frames:
        return None
    return (100.0 * flops * rec.frames / rec.window_s
            / PEAK_FLOP_PER_S[precision])


def idle_share(rec):
    """Share of the traced window in which no kernel or copy ran on the
    card (the union of device intervals against the window). Not clipped
    at 0: a busy time longer than the window is a wrong count, and
    shows."""
    if not rec.device or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s() / rec.window_s)
