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

The gradient: `GRUSequenceFn` (a torch.autograd.Function) runs the
forward's training variant, `gru_sequence_gates` (the same kernel, which
also writes every step's gates r | z | n | gh_n, (T, B, 4H)), and saves
the gates, h0, w_hh and the outputs; its backward runs
`gru_sequence_backward`, the backward pass through time of
`csrc/gru_sequence_backward.cu` (the TPU kernel has none: JAX
differentiates its lax.scan), which reads the saved gates instead of
recomputing them and gives d x_proj, the hidden-side gate gradients dgh
and d h0, and finishes the weight gradients with two large products
over all steps, dW_hh = dgh^T h_prev and db_hh = sum dgh. `gru_sequence`
goes through the Function whenever grad is enabled and an input
requires it: on a CUDA tensor both directions run the kernels (or
raise), on a CPU tensor `gru_sequence_gates_plain` and
`gru_sequence_backward_plain`. `gru_sequence_backward_recompute`, which
recomputes the gates from x_proj, is the oracle the tests hold the
saved-gate path against.

bf16 (the JAX package's compute_dtype: bfloat16, whose `gru_layer` casts
x_proj, h0, w_hh and b_hh to bf16 and carries h in bf16): bf16 tensors
launch the bf16 instantiations of both kernels (counted in
`launches_bf16`), never the fp32 ones, and on the CPU take the same
plain versions, which then compute each step in fp32 from the bf16
values and round the new h to bf16 (the carry), and the outputs, gates
and gradients to bf16, as the kernels do. dW_hh and db_hh stay two
products outside the kernel, in fp32 from the bf16 dgh and states.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gesture2vec_tpu_torch.models.layers import as_fp32
from gesture2vec_tpu_torch.ops.build import count_launch

# the kernel's tile (csrc/gru_sequence.cu's R, C and RT): batch rows per
# cluster, blocks per cluster, rows per thread
ROWS, CLUSTER, ROWS_PER_THREAD = 20, 4, 4
_SMEM_LIMIT = 232448
# the backward kernel's launch bound (csrc/gru_sequence_backward.cu)
_BACKWARD_THREADS = 320
# clusters of 4 such blocks that an H100 SXM holds at once
# (cudaOccupancyMaxActiveClusters, reported by chip_smoke.py)
H100_MAX_CLUSTERS = 30


def _slice_bytes(U: int, width: int, dtype: torch.dtype) -> int:
    """A block's 3U x width w_hh slice in the storage type, rounded up to
    16 bytes (the kernels' slice_bytes)."""
    size = 2 if dtype == torch.bfloat16 else 4
    return -(-size * 3 * U * width // 16) * 16


def launch_shape(B: int, H: int, max_clusters: int = H100_MAX_CLUSTERS,
                 dtype: torch.dtype = torch.float32) -> dict:
    """The kernel's launch for a batch of B rows at hidden size H, as
    `csrc/gru_sequence.cu` computes it (`threads_for`, `smem_bytes<T>`),
    and how many waves of clusters it takes. Raises ValueError when the
    block's shared memory (its w_hh slice, the tile's state twice, fp32's
    x_proj slots) exceeds the card's 232,448 bytes, which happens above
    H=232 in fp32 and H=340 in bf16 (a bf16 slice is half the bytes and
    bf16 x_proj goes to registers)."""
    U = -(-H // CLUSTER)                    # hidden units per block
    q = -(-H // 4)
    HP = 4 * (q if q % 2 else q + 1)        # padded row: odd float4s
    threads = -(-U * (ROWS // ROWS_PER_THREAD) // 32) * 32
    slots = 2 * ROWS * 3 * U if dtype != torch.bfloat16 else 0
    smem = _slice_bytes(U, HP, dtype) + 4 * (2 * ROWS * HP + slots + 3 * U)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"H={H} needs {smem} B of shared memory per block "
                         f"(its w_hh slice, the tile's state twice, x_proj "
                         f"slots) in {dtype}, more than {_SMEM_LIMIT}")
    clusters = -(-B // ROWS)
    return {"rows": ROWS, "cluster": CLUSTER, "threads": threads,
            "smem_bytes": smem, "clusters": clusters,
            "blocks": clusters * CLUSTER,
            "waves": -(-clusters // max_clusters)}


def _step(xp: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor,
          b_hh: torch.Tensor):
    """One step of the kernel's math: (h', (r, z, n, gh_n))."""
    H = h.shape[-1]
    gh = torch.addmm(b_hh, h, w_hh.t())
    r = torch.sigmoid(xp[:, :H] + gh[:, :H])
    z = torch.sigmoid(xp[:, H:2 * H] + gh[:, H:2 * H])
    ghn = gh[:, 2 * H:]
    n = torch.tanh(xp[:, 2 * H:] + r * ghn)
    return (1.0 - z) * n + z * h, (r, z, n, ghn)


def _recurrence(x_proj, h0, w_hh, b_hh, reverse, keep_gates):
    store = x_proj.dtype
    x_proj, h0, w_hh, b_hh = map(as_fp32, (x_proj, h0, w_hh, b_hh))
    h = h0
    T = x_proj.shape[0]
    ys, gates = [None] * T, [None] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        h, g = _step(x_proj[t], h, w_hh, b_hh)
        # the carry in the storage type (bf16 rounds; else the identity)
        h = h.to(store).to(h.dtype)
        ys[t] = h
        if keep_gates:
            gates[t] = torch.cat(g, dim=1)
    out = (torch.stack(ys, dim=0).to(store), h.to(store))
    return out + (torch.stack(gates, dim=0).to(store),) if keep_gates \
        else out


def gru_sequence_plain(x_proj: torch.Tensor, h0: torch.Tensor,
                       w_hh: torch.Tensor, b_hh: torch.Tensor,
                       reverse: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math as a plain PyTorch loop."""
    return _recurrence(x_proj, h0, w_hh, b_hh, reverse, keep_gates=False)


def gru_sequence_gates_plain(x_proj: torch.Tensor, h0: torch.Tensor,
                             w_hh: torch.Tensor, b_hh: torch.Tensor,
                             reverse: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The training variant's math as a plain PyTorch loop: (outputs,
    last hidden, gates (T, B, 4H) = r | z | n | gh_n of every step)."""
    return _recurrence(x_proj, h0, w_hh, b_hh, reverse, keep_gates=True)


def backward_launch_shape(B: int, H: int,
                          max_clusters: int = H100_MAX_CLUSTERS,
                          dtype: torch.dtype = torch.float32) -> dict:
    """The backward kernel's launch (`csrc/gru_sequence_backward.cu`'s
    `threads_for`, `smem_bytes<T>`): the forward's tile and threads, with
    shared memory for the w_hh slice (rows of H rounded up to 4 values),
    two rounds of the cluster's partial sums and the step's dgh rows.
    Raises ValueError above 232,448 bytes a block (fp32: above H=244) or
    above the kernel's 320 threads (bf16: above H=256)."""
    U = -(-H // CLUSTER)
    W = 4 * -(-H // 4)
    threads = -(-U * (ROWS // ROWS_PER_THREAD) // 32) * 32
    smem = _slice_bytes(U, W, dtype) + 4 * (2 * CLUSTER * ROWS * U
                                            + 3 * U * ROWS)
    if smem > _SMEM_LIMIT or threads > _BACKWARD_THREADS:
        raise ValueError(f"H={H} needs {smem} B of shared memory and "
                         f"{threads} threads per block for the GRU backward "
                         f"in {dtype} (its w_hh slice, the cluster's "
                         f"partial sums, the step's dgh rows), more than "
                         f"{_SMEM_LIMIT} or {_BACKWARD_THREADS}")
    clusters = -(-B // ROWS)
    return {"rows": ROWS, "cluster": CLUSTER, "threads": threads,
            "smem_bytes": smem, "clusters": clusters,
            "blocks": clusters * CLUSTER,
            "waves": -(-clusters // max_clusters)}


def h_prev_stack(ys: torch.Tensor, h0: torch.Tensor,
                 reverse: bool) -> torch.Tensor:
    """(T, B, H): the state each step t started from (ys of the step taken
    before it, h0 for the first step taken)."""
    if reverse:
        return torch.cat([ys[1:], h0[None]], dim=0)
    return torch.cat([h0[None], ys[:-1]], dim=0)


def gates_from_ys(x_proj: torch.Tensor, h0: torch.Tensor,
                  w_hh: torch.Tensor, b_hh: torch.Tensor, ys: torch.Tensor,
                  reverse: bool = False) -> torch.Tensor:
    """The gates (T, B, 4H) of every step recomputed from the forward's
    inputs and outputs, one product over all steps: what the training
    variant saves, up to rounding."""
    T, B, H3 = x_proj.shape
    H = H3 // 3
    prev = h_prev_stack(ys, h0, reverse).reshape(T * B, H)
    _, g = _step(x_proj.reshape(T * B, H3), prev, w_hh, b_hh)
    return torch.cat(g, dim=1).reshape(T, B, 4 * H)


def gru_sequence_backward_plain(gates: torch.Tensor, h0: torch.Tensor,
                                w_hh: torch.Tensor, ys: torch.Tensor,
                                dys: torch.Tensor, dh_last: torch.Tensor,
                                reverse: bool = False
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The backward kernel's math as a plain PyTorch loop: from the gates
    the forward saved, its outputs ys and the gradients dys (T, B, H) of
    the outputs and dh_last (B, H) of the last hidden -> (d x_proj (T, B,
    3H), dgh (T, B, 3H), d h0 (B, H)). One product a step, dgh @ w_hh.
    bf16 inputs: computed in fp32, the three results rounded to bf16."""
    store = gates.dtype
    gates, h0, w_hh, ys, dys, dh_last = map(as_fp32, (gates, h0, w_hh, ys,
                                                      dys, dh_last))
    T = gates.shape[0]
    H = h0.shape[-1]
    prev = h_prev_stack(ys, h0, reverse)
    dxp = gates.new_empty((T, h0.shape[0], 3 * H))
    dgh = torch.empty_like(dxp)
    dh = dh_last
    for t in (range(T) if reverse else reversed(range(T))):
        r, z, n, ghn = gates[t].split(H, dim=1)
        dh = dh + dys[t]
        dpn = dh * (1.0 - z) * (1.0 - n * n)
        dpr = dpn * ghn * r * (1.0 - r)
        dpz = dh * (prev[t] - n) * z * (1.0 - z)
        dxp[t] = torch.cat([dpr, dpz, dpn], dim=1)
        dgh[t] = torch.cat([dpr, dpz, dpn * r], dim=1)
        dh = dh * z + dgh[t] @ w_hh
    return dxp.to(store), dgh.to(store), dh.to(store)


def gru_sequence_backward_recompute(x_proj: torch.Tensor, h0: torch.Tensor,
                                    w_hh: torch.Tensor, b_hh: torch.Tensor,
                                    ys: torch.Tensor, dys: torch.Tensor,
                                    dh_last: torch.Tensor,
                                    reverse: bool = False
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """The same gradients from x_proj instead of saved gates, recomputing
    each step's gates from h_prev: the oracle the tests hold the saved-gate
    path against."""
    T = x_proj.shape[0]
    H = h0.shape[-1]
    prev = h_prev_stack(ys, h0, reverse)
    dxp = torch.empty_like(x_proj)
    dgh = torch.empty_like(x_proj)
    dh = dh_last
    for t in (range(T) if reverse else reversed(range(T))):
        xp, hp = x_proj[t], prev[t]
        gh = torch.addmm(b_hh, hp, w_hh.t())
        r = torch.sigmoid(xp[:, :H] + gh[:, :H])
        z = torch.sigmoid(xp[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(xp[:, 2 * H:] + r * gh[:, 2 * H:])
        dh = dh + dys[t]
        dpn = dh * (1.0 - z) * (1.0 - n * n)
        dpr = dpn * gh[:, 2 * H:] * r * (1.0 - r)
        dpz = dh * (hp - n) * z * (1.0 - z)
        dxp[t] = torch.cat([dpr, dpz, dpn], dim=1)
        dgh[t] = torch.cat([dpr, dpz, dpn * r], dim=1)
        dh = dh * z + dgh[t] @ w_hh
    return dxp, dgh, dh


def _dtype(x_proj: torch.Tensor) -> torch.dtype:
    """The storage type the call runs in: float32 or bfloat16 (each has
    its kernel instantiation); the plain versions on the CPU also take
    float64 (the gradient checks)."""
    if x_proj.dtype == torch.bfloat16 or (
            x_proj.device.type == "cpu" and x_proj.dtype == torch.float64):
        return x_proj.dtype
    return torch.float32


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
        if t.dtype != _dtype(x_proj):
            raise ValueError(f"{name}: dtype {t.dtype}, want "
                             f"{_dtype(x_proj)}")
        if t.device != x_proj.device:
            raise ValueError(f"{name} is on {t.device}, x_proj on "
                             f"{x_proj.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if T == 0 or B == 0 or H == 0:
        raise ValueError("empty sequence, batch or hidden")
    launch_shape(B, H, dtype=x_proj.dtype)


def _suffix(dtype: torch.dtype) -> str:
    """The kernels' entry-point suffix of a storage type."""
    return "_bf16" if dtype == torch.bfloat16 else ""


def _run(fn_name, n_out, x_proj, h0, w_hh, b_hh, reverse):
    from gesture2vec_tpu_torch.ops.build import load

    fn = getattr(load("gru_sequence"), fn_name + _suffix(x_proj.dtype))
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (4 + n_out) + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    T, B, H3 = x_proj.shape
    H = H3 // 3
    outs = [torch.empty(shape, dtype=x_proj.dtype, device=x_proj.device)
            for shape in ((T, B, H), (B, H), (T, B, 4 * H))[:n_out]]
    stream = torch.cuda.current_stream(x_proj.device).cuda_stream
    err = fn(x_proj.data_ptr(), h0.data_ptr(), w_hh.data_ptr(),
             b_hh.data_ptr(), *(o.data_ptr() for o in outs), T, B, H,
             int(reverse), stream)
    if err != 0:
        raise RuntimeError(f"gru_sequence kernel launch failed ({fn_name}, "
                           f"{x_proj.dtype}): CUDA error {err}")
    # gru_sequence counts the source's launches, either variant;
    # gru_sequence_gates those of the gate-saving variant
    count_launch(gru_sequence, x_proj.dtype)
    if n_out == 3:
        count_launch(gru_sequence_gates, x_proj.dtype)
    return tuple(outs)


def _launch(x_proj, h0, w_hh, b_hh, reverse):
    return _run("g2v_gru_sequence", 2, x_proj, h0, w_hh, b_hh, reverse)


def _launch_gates(x_proj, h0, w_hh, b_hh, reverse):
    return _run("g2v_gru_sequence_gates", 3, x_proj, h0, w_hh, b_hh, reverse)


def _forward(x_proj, h0, w_hh, b_hh, reverse, gates=False):
    if x_proj.device.type == "cpu":
        plain = gru_sequence_gates_plain if gates else gru_sequence_plain
        return plain(x_proj, h0, w_hh, b_hh, reverse)
    if x_proj.device.type != "cuda":
        raise ValueError(f"no GRU kernel for device {x_proj.device}")
    return (_launch_gates if gates else _launch)(x_proj, h0, w_hh, b_hh,
                                                 reverse)


def gru_sequence_gates(x_proj: torch.Tensor, h0: torch.Tensor,
                       w_hh: torch.Tensor, b_hh: torch.Tensor,
                       reverse: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The training variant: (outputs (T, B, H), last hidden (B, H), gates
    (T, B, 4H) = r | z | n | gh_n of every step). Outputs are bitwise
    those of `gru_sequence`. CUDA tensors launch the kernel's variant
    (counted in `gru_sequence_gates.launches`, bf16 in `launches_bf16`,
    and among `gru_sequence`'s); CPU tensors take
    `gru_sequence_gates_plain`. No autograd: `GRUSequenceFn` calls it."""
    _check(x_proj, h0, w_hh, b_hh)
    return _forward(x_proj, h0, w_hh, b_hh, reverse, gates=True)


gru_sequence_gates.launches = gru_sequence_gates.launches_bf16 = 0


def _launch_backward(gates, h0, w_hh, ys, dys, dh_last, reverse):
    from gesture2vec_tpu_torch.ops.build import load

    fn = getattr(load("gru_sequence_backward"),
                 "g2v_gru_sequence_backward" + _suffix(gates.dtype))
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    T, B, H = ys.shape
    backward_launch_shape(B, H, dtype=gates.dtype)
    dxp = gates.new_empty((T, B, 3 * H))
    dgh = torch.empty_like(dxp)
    dh0 = torch.empty_like(h0)
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    err = fn(gates.data_ptr(), h0.data_ptr(), w_hh.data_ptr(),
             ys.data_ptr(), dys.data_ptr(), dh_last.data_ptr(),
             dxp.data_ptr(), dgh.data_ptr(), dh0.data_ptr(), T, B, H,
             int(reverse), stream)
    if err != 0:
        raise RuntimeError(f"gru_sequence_backward kernel launch failed "
                           f"({gates.dtype}): CUDA error {err}")
    count_launch(gru_sequence_backward, gates.dtype)
    return dxp, dgh, dh0


def gru_sequence_backward(gates: torch.Tensor, h0: torch.Tensor,
                          w_hh: torch.Tensor, ys: torch.Tensor,
                          dys: torch.Tensor, dh_last: torch.Tensor,
                          reverse: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(d x_proj (T, B, 3H), dgh (T, B, 3H), d h0 (B, H)) from the gates
    the training variant saved (T, B, 4H), the forward's h0, w_hh and
    outputs ys, and the gradients dys, dh_last, all fp32 or all bf16. CUDA
    tensors launch the kernel (counted in `gru_sequence_backward.launches`,
    bf16 in `launches_bf16`); CPU tensors take the plain version."""
    if gates.dim() != 3 or gates.shape[2] % 4:
        raise ValueError(f"gates: shape {tuple(gates.shape)}, want "
                         f"(T, B, 4H)")
    T, B, H4 = gates.shape
    H = H4 // 4
    dtype = _dtype(gates)
    for name, t, shape in (("gates", gates, (T, B, 4 * H)),
                           ("h0", h0, (B, H)), ("w_hh", w_hh, (3 * H, H)),
                           ("ys", ys, (T, B, H)), ("dys", dys, (T, B, H)),
                           ("dh_last", dh_last, (B, H))):
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != gates.device or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {dtype} {shape} "
                             f"on {gates.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if T == 0 or B == 0 or H == 0:
        raise ValueError("empty sequence, batch or hidden")
    if gates.device.type == "cpu":
        return gru_sequence_backward_plain(gates, h0, w_hh, ys, dys, dh_last,
                                           reverse)
    if gates.device.type != "cuda":
        raise ValueError(f"no GRU kernel for device {gates.device}")
    return _launch_backward(gates, h0, w_hh, ys, dys, dh_last, reverse)


gru_sequence_backward.launches = gru_sequence_backward.launches_bf16 = 0


class GRUSequenceFn(torch.autograd.Function):
    """The GRU sequence with its gradient: forward `gru_sequence_gates`'s
    kernel variant (or plain version on the CPU), which saves every step's
    gates; backward `gru_sequence_backward`'s from those gates, then dW_hh
    = dgh^T h_prev and db_hh = sum dgh over all steps. The backward kernel
    takes every shape the forward takes (H <= 244 against 232)."""

    @staticmethod
    def forward(ctx, x_proj, h0, w_hh, b_hh, reverse):
        ys, h_last, gates = _forward(x_proj, h0, w_hh, b_hh, reverse,
                                     gates=True)
        ctx.save_for_backward(gates, h0, w_hh, ys)
        ctx.reverse = reverse
        return ys, h_last

    @staticmethod
    def backward(ctx, dys, dh_last):
        gates, h0, w_hh, ys = ctx.saved_tensors
        dys = torch.zeros_like(ys) if dys is None else dys.contiguous()
        dh_last = (torch.zeros_like(h0) if dh_last is None
                   else dh_last.contiguous())
        dxp, dgh, dh0 = gru_sequence_backward(
            gates, h0, w_hh, ys, dys, dh_last, ctx.reverse)
        T, B, H3 = dgh.shape
        # fp32 products (bf16: from the bf16 dgh and states), returned in
        # w_hh's storage type
        dgh32, prev = map(as_fp32, (dgh, h_prev_stack(ys, h0,
                                                       ctx.reverse)))
        dw_hh = dgh32.reshape(T * B, H3).t() @ prev.reshape(T * B, -1)
        return (dxp, dh0, dw_hh.to(w_hh.dtype),
                dgh32.sum(dim=(0, 1)).to(w_hh.dtype), None)


def gru_sequence(x_proj: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor,
                 b_hh: torch.Tensor, reverse: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(outputs (T, B, H), last hidden (B, H)), all inputs fp32 or all
    bf16. CUDA tensors launch the kernel (counted in
    `gru_sequence.launches`, bf16 in `launches_bf16`); CPU tensors take the
    plain version. With grad enabled and an input that requires it, the
    call goes through `GRUSequenceFn`, whose backward is the backward
    kernel."""
    _check(x_proj, h0, w_hh, b_hh)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_proj, h0, w_hh, b_hh)):
        return GRUSequenceFn.apply(x_proj, h0, w_hh, b_hh, reverse)
    return _forward(x_proj, h0, w_hh, b_hh, reverse)


gru_sequence.launches = gru_sequence.launches_bf16 = 0
