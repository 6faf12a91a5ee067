"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Every kernel source under ``csrc/`` has a plain C interface, so it builds
in seconds into a shared library of its own, without PyTorch's headers:
``build_library`` compiles one source for ``sm_90a`` into
``build/cphnsw_tpu_torch/lib<stem>-<hash>.so`` beside the package, named
by the hash of the source and the flags, with ptxas's ``-v`` report
(registers, shared memory, spills) kept beside it (``build_log``).  A
build that exists is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "cphnsw_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc(source: Path) -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found: the CUDA toolkit is needed to "
                           f"build csrc/{source.name}")
    return path


def library_path(source: Path, extra_flags=(),
                 build_dir: Path = BUILD_DIR) -> Path:
    """Where ``build_library`` puts the build of `source` with NVCC_FLAGS
    plus `extra_flags`: named by the hash of the source and all the
    flags."""
    flags = " ".join([*NVCC_FLAGS, *extra_flags])
    tag = hashlib.sha256(source.read_bytes() + flags.encode()).hexdigest()[:16]
    return Path(build_dir) / f"lib{source.stem}-{tag}.so"


def build_library(source: Path, extra_flags=(),
                  build_dir: Path = BUILD_DIR) -> tuple[Path, float]:
    """Compile `source` with NVCC_FLAGS plus `extra_flags` into
    ``library_path``; returns (path, seconds spent compiling), 0.0 seconds
    when that library already exists."""
    out = library_path(source, extra_flags, build_dir)
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(source), *NVCC_FLAGS, *extra_flags, "-o",
                           str(tmp), str(source)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{source.name} "
                           f"({proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    build_log(out).write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


def build_log(library: Path) -> Path:
    return library.with_suffix(".log")


def load(path: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(Path(path).resolve()))
