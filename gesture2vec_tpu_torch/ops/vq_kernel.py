"""Fused nearest-code search: the Hopper kernel and its plain version.

Replaces the TPU kernel `gesture2vec_tpu/ops/vq_pallas.py`
(`_vq_argmin_padded` / `vq_argmin` -> `_vq_kernel`). The kernel itself
is `csrc/vq_argmin.cu`; its source note gives the bound and the design.

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


def _launch(x: torch.Tensor, codebook: torch.Tensor):
    from gesture2vec_tpu_torch.ops.build import load

    fn = load("vq_argmin").g2v_vq_argmin
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    N, D = x.shape
    K = codebook.shape[0]
    e2 = torch.sum(codebook * codebook, dim=1)
    idx = torch.empty((N,), dtype=torch.int64, device=x.device)
    dmin = torch.empty((N,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), codebook.data_ptr(), e2.data_ptr(),
             idx.data_ptr(), dmin.data_ptr(), N, K, D, stream)
    if err != 0:
        raise RuntimeError(f"vq_argmin kernel launch failed: CUDA error "
                           f"{err}")
    vq_argmin.launches += 1
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
