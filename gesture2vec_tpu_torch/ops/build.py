"""Build and load the port's CUDA kernels.

Each source under `gesture2vec_tpu_torch/csrc/` is compiled by `nvcc`
into a shared library with a plain C interface and loaded with ctypes
(no PyTorch headers, so a build takes seconds). Libraries go into
`build/kernels/` at the repo root, named by a hash of the source and the
flags, so a changed source or header is rebuilt and an unchanged one is
reused. The GRU-sequence, GRU-backward and chunk-decoder sources each
hold an fp32 and a bf16 instantiation (`_bf16` entry points; the shared
storage helpers are `csrc/storage.cuh`).
Nothing is built or loaded at import time. `load` and the launch
counters are safe under threads: a server's handler threads make the
first kernel calls concurrently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {"chunk_decoder": "chunk_decoder.cu",
           "gru_sequence": "gru_sequence.cu",
           "gru_sequence_backward": "gru_sequence_backward.cu",
           "vq_argmin": "vq_argmin.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_count_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found; the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library of one source, named by a hash of the source, the
    headers under csrc/ (which every source may include) and the flags."""
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def _command(name: str, out: Path) -> list:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / SOURCES[name])]


def build_all() -> Dict[str, Tuple[Path, str]]:
    """Compile every kernel source that has no library yet, one nvcc
    process per source, all started together. Returns
    {name: (library path, compiler log)}; the log holds ptxas's register,
    shared-memory and spill lines (read from the saved .log when the
    library was already built). Raises if a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        lib = library_path(name)
        if not lib.exists():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        lib = library_path(name)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    out = {}
    for name in SOURCES:
        lib = library_path(name)
        log_file = lib.with_suffix(".log")
        out[name] = (lib, log_file.read_text() if log_file.exists() else "")
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use (once,
    whatever the number of threads asking)."""
    with _load_lock:
        if name not in _loaded:
            lib = library_path(name)
            if not lib.exists():
                build_all()
            _loaded[name] = ctypes.CDLL(str(lib))
        return _loaded[name]


def counter(dtype) -> str:
    """The attribute of a kernel wrapper that counts its launches on
    tensors of this dtype: `launches` (fp32), `launches_bf16` (bf16)."""
    import torch

    return "launches_bf16" if dtype == torch.bfloat16 else "launches"


def count_launch(wrapper, dtype=None) -> None:
    """Adds one to a kernel wrapper's launch count for dtype (`counter`;
    fp32 when None): a read, add and write, so under a lock."""
    name = "launches" if dtype is None else counter(dtype)
    with _count_lock:
        setattr(wrapper, name, getattr(wrapper, name) + 1)
