"""Single-layer GRU recurrence over a sequence: the Hopper kernel and its
plain version.

Replaces the TPU kernel `gesture2vec_tpu/ops/gru_pallas.py`
(`gru_sequence_fused` -> `_gru_seq_kernel`). The kernel itself is
`csrc/gru_sequence.cu`; its source note gives the bound and the design:
one thread-block cluster per tile of batch rows, each block holding its
slice of w_hh in shared memory for the whole launch.

`gru_sequence(x_proj, h0, w_hh, b_hh, reverse)` takes the hoisted input
projections x_proj = xs @ w_ih^T + b_ih (T, B, 3H), the initial state
h0 (B, H) and the recurrent weights in torch layout (3H, H), and
returns (outputs (T, B, H), last hidden (B, H)): the math of
`models/gru.gru_layer`. `reverse=True` walks t = T-1 .. 0 with outputs
kept at their time positions (`lax.scan(reverse=True)`). On a CUDA
tensor it launches the kernel (or raises); on a CPU tensor it runs
`gru_sequence_plain`, a plain loop over the same gate math.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gesture2vec_tpu_torch.ops.build import count_launch

# the kernel's tile (csrc/gru_sequence.cu's R, C and RT): batch rows per
# cluster, blocks per cluster, rows per thread
ROWS, CLUSTER, ROWS_PER_THREAD = 20, 4, 4
_SMEM_LIMIT = 232448
# clusters of 4 such blocks that an H100 SXM holds at once
# (cudaOccupancyMaxActiveClusters, reported by chip_smoke.py)
H100_MAX_CLUSTERS = 30


def launch_shape(B: int, H: int,
                 max_clusters: int = H100_MAX_CLUSTERS) -> dict:
    """The kernel's launch for a batch of B rows at hidden size H, as
    `csrc/gru_sequence.cu` computes it (`threads_for`, `smem_bytes`), and
    how many waves of clusters it takes. Raises ValueError when the
    block's shared memory (its w_hh slice, the tile's state twice, x_proj
    slots) exceeds the card's 232,448 bytes, which happens above H=232."""
    U = -(-H // CLUSTER)                    # hidden units per block
    q = -(-H // 4)
    HP = 4 * (q if q % 2 else q + 1)        # padded row: odd float4s
    threads = -(-U * (ROWS // ROWS_PER_THREAD) // 32) * 32
    smem = 4 * (3 * U * HP + 2 * ROWS * HP + 2 * ROWS * 3 * U + 3 * U)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"H={H} needs {smem} B of shared memory per block "
                         f"(its w_hh slice, the tile's state twice, x_proj "
                         f"slots), more than {_SMEM_LIMIT}")
    clusters = -(-B // ROWS)
    return {"rows": ROWS, "cluster": CLUSTER, "threads": threads,
            "smem_bytes": smem, "clusters": clusters,
            "blocks": clusters * CLUSTER,
            "waves": -(-clusters // max_clusters)}


def gru_sequence_plain(x_proj: torch.Tensor, h0: torch.Tensor,
                       w_hh: torch.Tensor, b_hh: torch.Tensor,
                       reverse: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math as a plain PyTorch loop."""
    H = h0.shape[-1]
    h = h0
    ys = [None] * x_proj.shape[0]
    steps = range(x_proj.shape[0])
    for t in (reversed(steps) if reverse else steps):
        xp = x_proj[t]
        gh = torch.addmm(b_hh, h, w_hh.t())
        r = torch.sigmoid(xp[:, :H] + gh[:, :H])
        z = torch.sigmoid(xp[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(xp[:, 2 * H:] + r * gh[:, 2 * H:])
        h = (1.0 - z) * n + z * h
        ys[t] = h
    return torch.stack(ys, dim=0), h


def _check(x_proj, h0, w_hh, b_hh) -> None:
    if x_proj.dim() != 3:
        raise ValueError(f"x_proj: shape {tuple(x_proj.shape)}, want "
                         f"(T, B, 3H)")
    T, B, H3 = x_proj.shape
    H = H3 // 3
    want = {"x_proj": (x_proj, (T, B, 3 * H)), "h0": (h0, (B, H)),
            "w_hh": (w_hh, (3 * H, H)), "b_hh": (b_hh, (3 * H,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, want float32")
        if t.device != x_proj.device:
            raise ValueError(f"{name} is on {t.device}, x_proj on "
                             f"{x_proj.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if T == 0 or B == 0 or H == 0:
        raise ValueError("empty sequence, batch or hidden")
    launch_shape(B, H)


def _launch(x_proj, h0, w_hh, b_hh, reverse):
    from gesture2vec_tpu_torch.ops.build import load

    fn = load("gru_sequence").g2v_gru_sequence
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    T, B, H3 = x_proj.shape
    H = H3 // 3
    ys = torch.empty((T, B, H), dtype=torch.float32, device=x_proj.device)
    h_last = torch.empty((B, H), dtype=torch.float32, device=x_proj.device)
    stream = torch.cuda.current_stream(x_proj.device).cuda_stream
    err = fn(x_proj.data_ptr(), h0.data_ptr(), w_hh.data_ptr(),
             b_hh.data_ptr(), ys.data_ptr(), h_last.data_ptr(), T, B, H,
             int(reverse), stream)
    if err != 0:
        raise RuntimeError(f"gru_sequence kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(gru_sequence)
    return ys, h_last


def gru_sequence(x_proj: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor,
                 b_hh: torch.Tensor, reverse: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(outputs (T, B, H), last hidden (B, H)). CUDA tensors launch the
    kernel (counted in `gru_sequence.launches`); CPU tensors take the
    plain version."""
    _check(x_proj, h0, w_hh, b_hh)
    if x_proj.device.type == "cpu":
        return gru_sequence_plain(x_proj, h0, w_hh, b_hh, reverse)
    if x_proj.device.type != "cuda":
        raise ValueError(f"no GRU kernel for device {x_proj.device}")
    return _launch(x_proj, h0, w_hh, b_hh, reverse)


gru_sequence.launches = 0
