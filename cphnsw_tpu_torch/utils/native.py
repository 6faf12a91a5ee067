"""ctypes loader for the native host-ops library (``native/hostops.c``).

PyTorch-side counterpart of ``cphnsw_tpu/utils/native.py``.  The same
plain-C source (BFS renumbering, capped reverse-edge lists) is compiled at
first use with the system C compiler into ``build/cphnsw_tpu_torch/``,
named by the hash of the source.  These are host ops, not device kernels:
every entry point returns None when the library cannot be built, and the
caller then takes its numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "hostops.c"
BUILD_DIR = _ROOT / "build" / "cphnsw_tpu_torch"

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libhostops-{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cc = os.environ.get("CC", "cc")
        subprocess.run([cc, "-O3", "-shared", "-fPIC", str(SOURCE), "-o",
                        str(tmp)], check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def load():
    """The loaded library, or None if it cannot be built here."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.bfs_order.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.bfs_order.restype = None
        lib.reverse_topk.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        lib.reverse_topk.restype = None
        _lib = lib
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def bfs_order(ids: np.ndarray, entry: int) -> np.ndarray | None:
    """Native BFS renumbering old_to_new; None if unavailable."""
    lib = load()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    n, r = ids.shape
    out = np.empty(n, dtype=np.int64)
    lib.bfs_order(_ptr(ids, ctypes.c_int32), n, r, int(entry),
                  _ptr(out, ctypes.c_int64))
    return out


def reverse_topk(ids: np.ndarray, dists: np.ndarray, r_rev: int
                 ) -> tuple[np.ndarray, np.ndarray] | None:
    """Native capped reverse-edge lists (closest r_rev sources per
    target, in heap order); None if unavailable."""
    lib = load()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    dists = np.ascontiguousarray(dists, dtype=np.float32)
    n, r = ids.shape
    out_ids = np.full((n, r_rev), -1, dtype=np.int32)
    out_d = np.full((n, r_rev), np.finfo(np.float32).max, dtype=np.float32)
    lib.reverse_topk(_ptr(ids, ctypes.c_int32), _ptr(dists, ctypes.c_float),
                     n, r, r_rev, _ptr(out_ids, ctypes.c_int32),
                     _ptr(out_d, ctypes.c_float))
    return out_ids, out_d
