"""The C++ volume reader: ``pautdx_io.cpp`` built with g++ and loaded with
ctypes.

The port's own copy of ``pautdx/native``. The library is compiled at first
use into ``build/pautdx_torch/`` at the root of the checkout, under a name
that hashes the source and the flags, so an edited source is rebuilt and
a stale one never loaded; the flags carry no ``-march=native``, because the
library is cached beside the checkout and may run on another host.

Unlike the reference, nothing falls back in silence: a failed build raises
with the compiler's output, which :func:`native_available` keeps
(:func:`native_error`) when it answers False. Without a C++ compiler at
all, :func:`native_available` is False and ``data.volume``'s parsers take
their numpy path. ``NATIVE_PARSES`` counts the parses the library
answered, so a run can show which path it took.

- :func:`load_ascan_txt`: one float-per-line A-scan file -> float32;
- :func:`parse_json_volume_fast`: a ``{beam: {scan: [floats]}}`` JSON
  volume in one pass -> ``data.volume.ParsedVolume``;
- :func:`parse_ascan_tree_fast`: ``base/<beam>/<scan>.txt`` parsed by a
  thread pool over mmap'd files -> ``{relpath: float32 array}``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SRC = Path(__file__).resolve().with_name("pautdx_io.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pautdx_torch"
FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

NATIVE_PARSES = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)


def compiler() -> Optional[str]:
    """The C++ compiler: ``$CXX``, else ``g++`` on the path, else None."""
    return os.environ.get("CXX") or shutil.which("g++")


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libpautdx_io-{digest[:12]}.so"


def _build() -> Path:
    out = lib_path()
    if out.is_file():
        return out
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("pautdx_torch.native: no C++ compiler (g++ or "
                           "$CXX) to build the volume reader")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"pautdx_torch.native: {cxx} failed (rc "
                           f"{proc.returncode}):\n"
                           + (proc.stdout + proc.stderr)[-4000:])
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises with the
    compiler's output if the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.parse_floats_file.restype = ctypes.c_int64
            lib.parse_floats_file.argtypes = [ctypes.c_char_p, _F32P,
                                              ctypes.c_int64]
            lib.parse_json_volume_floats.restype = ctypes.c_int64
            lib.parse_json_volume_floats.argtypes = [
                ctypes.c_char_p, _F32P, ctypes.c_int64, _I64P,
                ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64, _I64P,
                _I64P, _I64P]
            lib.parse_ascan_tree.restype = ctypes.c_int64
            lib.parse_ascan_tree.argtypes = [
                ctypes.c_char_p, _F32P, ctypes.c_int64, _I64P,
                ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64, _I64P,
                _I64P, _I64P, ctypes.c_int32]
            _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the library builds and loads here. False without a C++
    compiler; a failed build's message is kept in :func:`native_error`."""
    global _error
    if compiler() is None:
        _error = "no C++ compiler (g++ or $CXX)"
        return False
    try:
        load()
    except (RuntimeError, OSError) as e:
        _error = str(e)
        return False
    return True


def native_error() -> Optional[str]:
    """Why :func:`native_available` last answered False, else None."""
    return _error


def load_ascan_txt(path: str, max_samples: int = 1 << 20) -> np.ndarray:
    """Float-per-line A-scan file -> float32 array (``np.loadtxt``'s)."""
    global NATIVE_PARSES
    out = np.empty(max_samples, np.float32)
    n = load().parse_floats_file(os.fsencode(path),
                                 out.ctypes.data_as(_F32P), max_samples)
    if n == -2:
        raise ValueError(f"malformed float token in {path}")
    if n < 0:
        raise FileNotFoundError(path)
    NATIVE_PARSES += 1
    return out[:n].copy()


def _scan_key(key: str) -> bool:
    """A scan key starts with its integer index; a beam key does not."""
    try:
        int(key.split("_")[0])
    except ValueError:
        return False
    return True


def parse_json_volume_fast(path: str):
    """One native pass over a JSON volume whose scans are plain float
    arrays -> ``ParsedVolume``, the numpy parser's result. A volume whose
    scans are ``{"signal": [...]}`` objects goes to the numpy parser (the
    scanner sees their keys); a file the scanner cannot read raises."""
    global NATIVE_PARSES
    from pautdx_torch.data import grammar
    from pautdx_torch.data.volume import ParsedVolume, parse_json_volume

    size = os.path.getsize(path)
    # a float takes at least two bytes of text, a key one more than itself
    value_cap = max(size // 2 + 4096, 1 << 16)
    length_cap = max(size // 2 + 16, 1 << 10)
    values = np.empty(value_cap, np.float32)
    lengths = np.empty(length_cap, np.int64)
    keys = ctypes.create_string_buffer(size + 16)
    n_values, n_arrays, n_key_bytes = (ctypes.c_int64() for _ in range(3))
    rc = load().parse_json_volume_floats(
        os.fsencode(path), values.ctypes.data_as(_F32P), value_cap,
        lengths.ctypes.data_as(_I64P), length_cap, keys, size + 16,
        ctypes.byref(n_values), ctypes.byref(n_arrays),
        ctypes.byref(n_key_bytes))
    if rc == -1:
        raise FileNotFoundError(path)
    if rc != 0:
        raise ValueError(f"native JSON scan of {path} failed (rc {rc})")
    all_keys = keys.raw[:n_key_bytes.value].decode().split("\n")[:-1]
    n_arr = n_arrays.value
    if sum(map(_scan_key, all_keys)) != n_arr or "signal" in all_keys:
        return parse_json_volume(path, use_native=False)
    offsets = np.concatenate([[0], np.cumsum(lengths[:n_arr])])
    signals, infos, beam_keys = {}, {}, []
    ai = i = 0
    while i < len(all_keys):
        bk = all_keys[i]
        i += 1
        rows = []
        while i < len(all_keys) and _scan_key(all_keys[i]):
            rows.append((all_keys[i],
                         values[offsets[ai]:offsets[ai + 1]].copy()))
            ai += 1
            i += 1
        by_key = dict(rows)
        rows = [(k, by_key[k]) for k in grammar.sort_scan_keys(list(by_key))]
        # ragged beams right-padded with zeros, as the numpy parser pads
        mat = np.zeros((len(rows), max((r.shape[0] for _, r in rows),
                                       default=0)), np.float32)
        for j, (_, r) in enumerate(rows):
            mat[j, :r.shape[0]] = r
        signals[bk] = mat
        infos[bk] = [grammar.parse_scan_key(k) for k, _ in rows]
        beam_keys.append(bk)
    try:
        beam_keys = grammar.sort_beams(beam_keys)
        angles = [grammar.beam_angle(k) for k in beam_keys]
    except (IndexError, ValueError):
        angles = list(range(len(beam_keys)))
    NATIVE_PARSES += 1
    return ParsedVolume(beam_keys, [float(a) for a in angles], signals,
                        infos)


def parse_ascan_tree_fast(base_dir: str, n_threads: int = 0
                          ) -> Dict[str, np.ndarray]:
    """Parallel mmap parse of an A-scan txt tree (``base/<beam>/<scan>.txt``)
    -> ``{"<beam>/<file>": float32 array}``; the walk, the float parsing
    and the thread pool are the library's (``parse_ascan_tree``). Raises
    on an unreadable tree or a malformed file."""
    global NATIVE_PARSES
    sizes = [(os.path.getsize(os.path.join(r, f)), len(f) + len(r))
             for r, _, fs in os.walk(base_dir) for f in fs]
    value_cap = max(sum(s for s, _ in sizes) // 2 + 4096, 1 << 16)
    n_cap = max(len(sizes), 1)
    path_cap = sum(n for _, n in sizes) + 16
    values = np.empty(value_cap, np.float32)
    lengths = np.empty(n_cap, np.int64)
    paths = ctypes.create_string_buffer(path_cap)
    n_files, n_values, n_path_bytes = (ctypes.c_int64() for _ in range(3))
    rc = load().parse_ascan_tree(
        os.fsencode(base_dir), values.ctypes.data_as(_F32P), value_cap,
        lengths.ctypes.data_as(_I64P), n_cap, paths, path_cap,
        ctypes.byref(n_files), ctypes.byref(n_values),
        ctypes.byref(n_path_bytes), n_threads)
    if rc != 0:
        raise ValueError(f"native parse of the txt tree {base_dir} failed "
                         f"(rc {rc}: -1 unreadable, -2 capacity, -3 a "
                         f"malformed or unreadable file)")
    rel = paths.raw[:n_path_bytes.value].decode().split("\n")[:-1]
    offsets = np.concatenate([[0], np.cumsum(lengths[:n_files.value])])
    NATIVE_PARSES += 1
    return {rel[i]: values[offsets[i]:offsets[i + 1]].copy()
            for i in range(n_files.value)}
