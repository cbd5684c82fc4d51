"""Fused Part-b chunk rollout: the Hopper kernel and its plain version.

Replaces the TPU kernel `gesture2vec_tpu/ops/decoder_pallas.py`
(`fused_chunk_decode` -> `_decoder_kernel`). The kernel itself is
`csrc/chunk_decoder.cu`; its source note gives the bound and the design:
a thread-block cluster of 16 blocks holds the decoder's weights in
shared memory for the whole launch and walks tiles of at most 8 rows.

`fold_decoder_step` folds eval BatchNorm and the pre_linear bias into
a scale/shift pair, as the JAX wrapper does, and keeps every weight in
the torch layout (out, in), so a hidden unit's GRU rows are contiguous
for the kernel's staging copies; the generator folds once, since
inference weights do not change. `fused_chunk_decode` then runs the
whole rollout: on a CUDA tensor it launches the kernel (or raises), on
a CPU tensor it runs `fused_chunk_decode_plain`, a plain PyTorch loop
over the same folded math that the tests hold against the JAX kernel.

bf16 (the validation decode of a compute_dtype: bfloat16 tokenizer):
`fold_decoder_step(step, torch.bfloat16)` folds in fp32 and stores the
folded weights in bf16; with bf16 seeds and hidden the call launches the
kernel's bf16 instantiation (counted in `launches_bf16`), never the fp32
one, and on the CPU the plain version computes each step in fp32 from the
bf16 values and rounds p, each layer's new h and each output to bf16,
as the kernel does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from gesture2vec_tpu_torch.models.gru import gru_cell
from gesture2vec_tpu_torch.models.layers import as_fp32
from gesture2vec_tpu_torch.models.seq_ae import DecoderStep
from gesture2vec_tpu_torch.ops.build import count_launch

# the kernel's launch (csrc/chunk_decoder.cu's C, RM and kThreads): blocks
# per cluster, most rows in a tile, threads per block
CLUSTER, MAX_ROWS, THREADS = 16, 8, 512
_SMEM_LIMIT = 232448
# 16-block clusters of these blocks that an H100 SXM holds at once
# (cudaOccupancyMaxActiveClusters, reported by chip_smoke.py)
H100_MAX_CLUSTERS = 7


class FoldedDecoder(NamedTuple):
    """Decoder-step weights in kernel layout: the torch layout (out, in),
    all fp32 or all bf16, contiguous."""
    w_pre: torch.Tensor      # (H, D)
    bn_scale: torch.Tensor   # (H,)
    bn_bias: torch.Tensor    # (H,) includes the pre_linear bias
    w0_ih: torch.Tensor      # (3H, H)
    w0_hh: torch.Tensor      # (3H, H)
    b0_ih: torch.Tensor      # (3H,)
    b0_hh: torch.Tensor      # (3H,)
    w1_ih: torch.Tensor
    w1_hh: torch.Tensor
    b1_ih: torch.Tensor
    b1_hh: torch.Tensor
    w_out: torch.Tensor      # (D, H)
    b_out: torch.Tensor      # (D,)


def smem_bytes(H: int, D: int, dtype: torch.dtype = torch.float32) -> int:
    """A block's shared memory, as `layout` in the kernel source counts it:
    the block's GRU rows (12 U rows of H4), w_pre with rows padded to 2
    float4s past a multiple of 4 (DP), w_out (these three in the storage
    type, each rounded up to 16 bytes), biases and BN, the block's new
    units (two layers, 8 rows of 16), and the tile's x, p and both layers'
    state twice for 8 rows (fp32)."""
    size = 2 if dtype == torch.bfloat16 else 4

    def wf(n):  # floats taken by n weights
        return 4 * -(-n * size // 16)

    U = -(-H // CLUSTER)
    H4 = 4 * -(-H // 4)
    q = -(-D // 4)
    DP = 4 * (q + (2 - q) % 4)
    DR = 4 * q
    floats = (4 + wf(12 * U * H4) + wf(H * DP) + wf(DR * H4) + 2 * H4 + DR
              + 4 * -(-12 * U // 4) + 2 * MAX_ROWS * 16 + MAX_ROWS * DP
              + 5 * MAX_ROWS * H4)
    return 4 * floats


def rows_for(B: int, max_clusters: int) -> int:
    """Rows per tile (the kernel's rows_for): as few rounds of tiles as the
    card's clusters allow, then as few rows a tile as those rounds allow."""
    rounds = -(-B // (MAX_ROWS * max_clusters))
    return min(-(-B // (rounds * max_clusters)), MAX_ROWS)


def launch_shape(B: int, H: int, D: int,
                 max_clusters: int = H100_MAX_CLUSTERS,
                 dtype: torch.dtype = torch.float32) -> dict:
    """The kernel's launch for B rows at hidden size H and frame width D,
    as `csrc/chunk_decoder.cu` computes it (`g2v_chunk_decode_shape`):
    rows per tile, blocks per cluster, threads, dynamic shared bytes,
    tiles, clusters in the (persistent) grid and the rounds of tiles each
    walks. Raises ValueError when a block's shared memory exceeds the
    card's 232,448 bytes (above H=204 at D=40 in fp32; above H=292 in
    bf16) or a block owns more than 16 units, a warp each (above H=256):
    bf16 takes H <= 256 at D=40."""
    smem = smem_bytes(H, D, dtype)
    if smem > _SMEM_LIMIT or -(-H // CLUSTER) > THREADS // 32:
        raise ValueError(f"H={H}, D={D} need {smem} B of shared memory per "
                         f"block in {dtype} (the block's GRU rows, w_pre, "
                         f"w_out and the tile's state) and a warp for each "
                         f"of {-(-H // CLUSTER)} units, more than "
                         f"{_SMEM_LIMIT} B or {THREADS // 32} warps")
    rows = rows_for(B, max_clusters)
    tiles = -(-B // rows)
    clusters = min(tiles, max_clusters)
    return {"rows": rows, "cluster": CLUSTER, "threads": THREADS,
            "smem_bytes": smem, "tiles": tiles, "clusters": clusters,
            "rounds": -(-tiles // clusters)}


def supported(step: DecoderStep, dtype: torch.dtype = torch.float32) -> str:
    """'' when the kernel can run this decoder step in dtype, else the
    reason."""
    gru = step.gru
    if gru.n_layers != 2:
        return f"the kernel runs 2 GRU layers, not {gru.n_layers}"
    if not step.conditioned:
        return "the kernel feeds each output back (conditioned decoders)"
    try:
        launch_shape(1, gru.hidden_size, step.pre_linear.in_features,
                     dtype=dtype)
    except ValueError as e:
        return str(e)
    return ""


@torch.no_grad()
def fold_decoder_step(step: DecoderStep,
                      dtype: torch.dtype = torch.float32) -> FoldedDecoder:
    """Eval BN folded to scale/shift: y = (x - mean) * s + beta with
    s = gamma / sqrt(var + eps); the pre_linear bias b enters as b * s.
    Folded in fp32, stored in dtype (fp32 or bf16)."""
    bn = step.pre_bn
    inv = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    bias = bn.bias - bn.running_mean * inv + step.pre_linear.bias * inv

    def c(t):
        return t.detach().float().to(dtype).contiguous()

    return FoldedDecoder(
        c(step.pre_linear.weight), c(inv), c(bias),
        *(c(t) for t in step.gru.layer_weights(0)),
        *(c(t) for t in step.gru.layer_weights(1)),
        c(step.out_layer.weight), c(step.out_layer.bias))


def fused_chunk_decode_plain(x0: torch.Tensor, h0: torch.Tensor,
                             w: FoldedDecoder, n_steps: int) -> torch.Tensor:
    """The kernel's math as a plain PyTorch loop: x0 (B, D), h0 (2, B, H)
    -> ys (n_steps, B, D). bf16: fp32 inside a step from the bf16 values,
    p, each layer's new h and each output rounded to bf16."""
    store = x0.dtype

    def rnd(t):  # the value stored in the storage type
        return t.to(store).to(t.dtype)

    w = FoldedDecoder(*map(as_fp32, w))
    x, h_a, h_b = as_fp32(x0), as_fp32(h0[0]), as_fp32(h0[1])
    ys = []
    for _ in range(n_steps):
        p = rnd(torch.relu((x @ w.w_pre.t()) * w.bn_scale + w.bn_bias))
        h_a = rnd(gru_cell(p, h_a, w.w0_ih, w.w0_hh, w.b0_ih, w.b0_hh))
        h_b = rnd(gru_cell(h_a, h_b, w.w1_ih, w.w1_hh, w.b1_ih, w.b1_hh))
        x = rnd(torch.addmm(w.b_out, h_b, w.w_out.t()))
        ys.append(x)
    return torch.stack(ys, dim=0).to(store)


def _check(x0: torch.Tensor, h0: torch.Tensor, w: FoldedDecoder) -> None:
    B, D = x0.shape
    H = w.w_pre.shape[0]
    want = {"x0": (x0, (B, D)), "h0": (h0, (2, B, H)),
            "w_pre": (w.w_pre, (H, D)), "bn_scale": (w.bn_scale, (H,)),
            "bn_bias": (w.bn_bias, (H,)), "w0_ih": (w.w0_ih, (3 * H, H)),
            "w0_hh": (w.w0_hh, (3 * H, H)), "b0_ih": (w.b0_ih, (3 * H,)),
            "b0_hh": (w.b0_hh, (3 * H,)), "w1_ih": (w.w1_ih, (3 * H, H)),
            "w1_hh": (w.w1_hh, (3 * H, H)), "b1_ih": (w.b1_ih, (3 * H,)),
            "b1_hh": (w.b1_hh, (3 * H,)), "w_out": (w.w_out, (D, H)),
            "b_out": (w.b_out, (D,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if t.dtype != x0.dtype or x0.dtype not in (torch.float32,
                                                   torch.bfloat16):
            raise ValueError(f"{name}: dtype {t.dtype}, want float32 or "
                             f"bfloat16, as x0 ({x0.dtype})")
        if t.device != x0.device:
            raise ValueError(f"{name} is on {t.device}, x0 on {x0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B == 0:
        raise ValueError("empty batch")


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype):
    """The kernel's C entry point for a storage type, typed once."""
    from gesture2vec_tpu_torch.ops.build import load

    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    fn = getattr(load("chunk_decoder"), "g2v_chunk_decode" + suffix)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    return fn


def _launch(x0: torch.Tensor, h0: torch.Tensor, w: FoldedDecoder,
            n_steps: int) -> torch.Tensor:
    B, D = x0.shape
    H = w.w_pre.shape[0]
    launch_shape(B, H, D, dtype=x0.dtype)
    ys = torch.empty((n_steps, B, D), dtype=x0.dtype, device=x0.device)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    err = _kernel(x0.dtype)(x0.data_ptr(), h0.data_ptr(),
                    *(t.data_ptr() for t in w), ys.data_ptr(), B, D, H,
                    n_steps, stream)
    if err != 0:
        raise RuntimeError(f"chunk_decoder kernel launch failed "
                           f"({x0.dtype}): CUDA error {err}")
    count_launch(fused_chunk_decode, x0.dtype)
    return ys


def fused_chunk_decode(x0: torch.Tensor, h0: torch.Tensor,
                       w: FoldedDecoder, n_steps: int) -> torch.Tensor:
    """The Part-b rollout for every chunk at once: x0 (B, D) seed frames,
    h0 (2, B, H) decoder-initial hidden -> ys (n_steps, B, D), the
    post-seed outputs of SeqDecoder.rollout, all fp32 or all bf16. CUDA
    tensors launch the kernel (counted in `fused_chunk_decode.launches`,
    bf16 in `launches_bf16`); CPU tensors take the plain version."""
    _check(x0, h0, w)
    if x0.device.type == "cpu":
        return fused_chunk_decode_plain(x0, h0, w, n_steps)
    if x0.device.type != "cuda":
        raise ValueError(f"no chunk decoder for device {x0.device}")
    return _launch(x0, h0, w, n_steps)


fused_chunk_decode.launches = fused_chunk_decode.launches_bf16 = 0
