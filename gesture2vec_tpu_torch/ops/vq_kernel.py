"""Fused nearest-code search: the Hopper kernel and its plain version.

Replaces the TPU kernel `gesture2vec_tpu/ops/vq_pallas.py`
(`_vq_argmin_padded` / `vq_argmin` -> `_vq_kernel`). The kernel itself
is `csrc/vq_argmin.cu`; its source note gives the bound and the design:
each block stages BM rows of x once and streams the codebook through a
ring of shared-memory slices.

`vq_argmin(x, codebook)` takes rows (N, D) and a codebook (K, D) and
returns (indices (N,) int64, minimum distances (N,) fp32) of
d = |x|^2 + |e|^2 - 2 x e^T, first index on ties, without writing the
(N, K) matrix. It carries K-Means' assignment (labels, the distances
for empty-cluster relocation and the inertia) and the residual-VQ
tokenizer's hard assignment. On a CUDA tensor it launches the kernel
(or raises); on a CPU tensor it runs `vq_argmin_plain`, which is
`codebook_distances` followed by min / argmin.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gesture2vec_tpu_torch.ops.build import count_launch


# the kernel's tiles (csrc/vq_argmin.cu's BN, BK, STAGES, TM x TN): codes
# per tile, dims per codebook slice, slices in the ring, a thread's rows
# and codes; the block's rows BM are chosen here
BLOCK_CODES, SLICE_DIMS, STAGES, THREAD_ROWS, THREAD_CODES = 64, 32, 2, 8, 4
BLOCK_ROWS = (128, 64, 32)
_SMEM_LIMIT = 232448
# streaming multiprocessors of an H100 SXM, for callers without a card
H100_SMS = 132


def _smem_bytes(block_rows: int, D: int) -> int:
    q = -(-D // 4)                          # the staged rows' stride
    ldx = 4 * (q if q % 8 else q + 1)
    return 4 * (block_rows * ldx
                + STAGES * BLOCK_CODES * (SLICE_DIMS + 4) + block_rows)


def launch_shape(N: int, D: int, n_sm: int = H100_SMS) -> dict:
    """The kernel's launch for N rows of width D: the largest BM whose
    rows fit shared memory beside the codebook ring and that still gives
    every SM a block, else the smallest BM that fits. Raises ValueError
    when 32 rows do not fit (D > 1,668)."""
    fits = [bm for bm in BLOCK_ROWS if _smem_bytes(bm, D) <= _SMEM_LIMIT]
    if not fits:
        raise ValueError(f"D={D}: {BLOCK_ROWS[-1]} rows of x and the codebook "
                         f"ring need {_smem_bytes(BLOCK_ROWS[-1], D)} B of "
                         f"shared memory, more than {_SMEM_LIMIT}")
    bm = next((b for b in fits if -(-N // b) >= n_sm), fits[-1])
    threads = bm // THREAD_ROWS * (BLOCK_CODES // THREAD_CODES)
    return {"block_rows": bm, "threads": threads,
            "smem_bytes": _smem_bytes(bm, D), "blocks": -(-N // bm)}


def codebook_distances(x: torch.Tensor, codebook: torch.Tensor
                       ) -> torch.Tensor:
    """Squared L2 distances (N, K) = |x|^2 + |e|^2 - 2 x e^T (fp32; the
    JAX package's `models/vq.codebook_distances`)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    e2 = torch.sum(codebook * codebook, dim=-1)
    return x2 + e2 - 2.0 * torch.matmul(x, codebook.t())


def vq_argmin_plain(x: torch.Tensor, codebook: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function through the full distance matrix."""
    dmin, idx = torch.min(codebook_distances(x, codebook), dim=1)
    return idx, dmin


def _check(x: torch.Tensor, codebook: torch.Tensor) -> None:
    if x.dim() != 2 or codebook.dim() != 2 or x.shape[1] != codebook.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and codebook "
                         f"{tuple(codebook.shape)}: want (N, D) and (K, D)")
    for name, t in (("x", x), ("codebook", codebook)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, want float32")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if 0 in x.shape or codebook.shape[0] == 0:
        raise ValueError("empty rows or codebook")
    launch_shape(x.shape[0], x.shape[1])


def _launch(x: torch.Tensor, codebook: torch.Tensor):
    from gesture2vec_tpu_torch.ops.build import load

    fn = load("vq_argmin").g2v_vq_argmin
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    N, D = x.shape
    K = codebook.shape[0]
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    bm = launch_shape(N, D, n_sm)["block_rows"]
    e2 = torch.sum(codebook * codebook, dim=1)
    idx = torch.empty((N,), dtype=torch.int64, device=x.device)
    dmin = torch.empty((N,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), codebook.data_ptr(), e2.data_ptr(),
             idx.data_ptr(), dmin.data_ptr(), N, K, D, bm, stream)
    if err != 0:
        raise RuntimeError(f"vq_argmin kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(vq_argmin)
    return idx, dmin


def vq_argmin(x: torch.Tensor, codebook: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices (N,) int64, minimum distances (N,)). CUDA tensors launch
    the kernel (counted in `vq_argmin.launches`); CPU tensors take the
    plain version."""
    _check(x, codebook)
    if x.device.type == "cpu":
        return vq_argmin_plain(x, codebook)
    if x.device.type != "cuda":
        raise ValueError(f"no VQ kernel for device {x.device}")
    return _launch(x, codebook)


vq_argmin.launches = 0
