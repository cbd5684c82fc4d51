"""Fused Part-b chunk rollout: the Hopper kernel and its plain version.

Replaces the TPU kernel `gesture2vec_tpu/ops/decoder_pallas.py`
(`fused_chunk_decode` -> `_decoder_kernel`). The kernel itself is
`csrc/chunk_decoder.cu`; its source note gives the bound and the design.

`fold_decoder_step` folds eval BatchNorm and the pre_linear bias into
a scale/shift pair and transposes the weights to (in, out), as the JAX
wrapper does; the generator folds once, since inference weights do not
change. `fused_chunk_decode` then runs the whole rollout: on a CUDA
tensor it launches the kernel (or raises), on a CPU tensor it runs
`fused_chunk_decode_plain`, a plain PyTorch loop over the same folded
math that the tests hold against the JAX kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gesture2vec_tpu_torch.models.gru import gru_cell
from gesture2vec_tpu_torch.models.seq_ae import DecoderStep

# chunk rows per block (kRows in the kernel); a block needs
# 4 * ROWS * (D + 5H) bytes of shared memory, at most 232,448 on an H100
ROWS = 8
_SMEM_LIMIT = 232448


class FoldedDecoder(NamedTuple):
    """Decoder-step weights in kernel layout (all fp32, contiguous)."""
    w_pre: torch.Tensor      # (D, H)
    bn_scale: torch.Tensor   # (H,)
    bn_bias: torch.Tensor    # (H,) includes the pre_linear bias
    w0_ih: torch.Tensor      # (H, 3H)
    w0_hh: torch.Tensor      # (H, 3H)
    b0_ih: torch.Tensor      # (3H,)
    b0_hh: torch.Tensor      # (3H,)
    w1_ih: torch.Tensor
    w1_hh: torch.Tensor
    b1_ih: torch.Tensor
    b1_hh: torch.Tensor
    w_out: torch.Tensor      # (H, D)
    b_out: torch.Tensor      # (D,)


def supported(step: DecoderStep) -> str:
    """'' when the kernel can run this decoder step, else the reason."""
    gru = step.gru
    if gru.n_layers != 2:
        return f"the kernel runs 2 GRU layers, not {gru.n_layers}"
    if not step.conditioned:
        return "the kernel feeds each output back (conditioned decoders)"
    D, H = step.pre_linear.in_features, gru.hidden_size
    if 4 * ROWS * (D + 5 * H) > _SMEM_LIMIT:
        return f"H={H}, D={D} exceed one block's shared memory"
    return ""


@torch.no_grad()
def fold_decoder_step(step: DecoderStep) -> FoldedDecoder:
    """Eval BN folded to scale/shift: y = (x - mean) * s + beta with
    s = gamma / sqrt(var + eps); the pre_linear bias b enters as b * s."""
    bn = step.pre_bn
    inv = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    bias = bn.bias - bn.running_mean * inv + step.pre_linear.bias * inv
    g = step.gru
    w0_ih, w0_hh, b0_ih, b0_hh = g.layer_weights(0)
    w1_ih, w1_hh, b1_ih, b1_hh = g.layer_weights(1)

    def c(t):
        return t.detach().float().contiguous()

    return FoldedDecoder(
        c(step.pre_linear.weight.t()), c(inv), c(bias),
        c(w0_ih.t()), c(w0_hh.t()), c(b0_ih), c(b0_hh),
        c(w1_ih.t()), c(w1_hh.t()), c(b1_ih), c(b1_hh),
        c(step.out_layer.weight.t()), c(step.out_layer.bias))


def fused_chunk_decode_plain(x0: torch.Tensor, h0: torch.Tensor,
                             w: FoldedDecoder, n_steps: int) -> torch.Tensor:
    """The kernel's math as a plain PyTorch loop: x0 (B, D), h0 (2, B, H)
    -> ys (n_steps, B, D)."""
    x, h_a, h_b = x0, h0[0], h0[1]
    ys = []
    for _ in range(n_steps):
        p = torch.relu((x @ w.w_pre) * w.bn_scale + w.bn_bias)
        # gru_cell takes torch-layout (3H, in) weights: .t() views undo
        # the fold's transpose
        h_a = gru_cell(p, h_a, w.w0_ih.t(), w.w0_hh.t(), w.b0_ih, w.b0_hh)
        h_b = gru_cell(h_a, h_b, w.w1_ih.t(), w.w1_hh.t(), w.b1_ih,
                       w.b1_hh)
        x = torch.addmm(w.b_out, h_b, w.w_out)
        ys.append(x)
    return torch.stack(ys, dim=0)


def _check(x0: torch.Tensor, h0: torch.Tensor, w: FoldedDecoder) -> None:
    B, D = x0.shape
    H = w.w_pre.shape[1]
    want = {"x0": (x0, (B, D)), "h0": (h0, (2, B, H)),
            "w_pre": (w.w_pre, (D, H)), "bn_scale": (w.bn_scale, (H,)),
            "bn_bias": (w.bn_bias, (H,)), "w0_ih": (w.w0_ih, (H, 3 * H)),
            "w0_hh": (w.w0_hh, (H, 3 * H)), "b0_ih": (w.b0_ih, (3 * H,)),
            "b0_hh": (w.b0_hh, (3 * H,)), "w1_ih": (w.w1_ih, (H, 3 * H)),
            "w1_hh": (w.w1_hh, (H, 3 * H)), "b1_ih": (w.b1_ih, (3 * H,)),
            "b1_hh": (w.b1_hh, (3 * H,)), "w_out": (w.w_out, (H, D)),
            "b_out": (w.b_out, (D,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, want float32")
        if t.device != x0.device:
            raise ValueError(f"{name} is on {t.device}, x0 on {x0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B == 0:
        raise ValueError("empty batch")


def _launch(x0: torch.Tensor, h0: torch.Tensor, w: FoldedDecoder,
            n_steps: int) -> torch.Tensor:
    from gesture2vec_tpu_torch.ops.build import load

    lib = load("chunk_decoder")
    fn = lib.g2v_chunk_decode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    B, D = x0.shape
    H = w.w_pre.shape[1]
    ys = torch.empty((n_steps, B, D), dtype=torch.float32, device=x0.device)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    err = fn(x0.data_ptr(), h0.data_ptr(), *(t.data_ptr() for t in w),
             ys.data_ptr(), B, D, H, n_steps, stream)
    if err != 0:
        raise RuntimeError(f"chunk_decoder kernel launch failed: CUDA "
                           f"error {err}")
    fused_chunk_decode.launches += 1
    return ys


def fused_chunk_decode(x0: torch.Tensor, h0: torch.Tensor,
                       w: FoldedDecoder, n_steps: int) -> torch.Tensor:
    """The Part-b rollout for every chunk at once: x0 (B, D) seed frames,
    h0 (2, B, H) decoder-initial hidden -> ys (n_steps, B, D), the
    post-seed outputs of SeqDecoder.rollout. CUDA tensors launch the
    kernel (counted in `fused_chunk_decode.launches`); CPU tensors take
    the plain version."""
    _check(x0, h0, w)
    if x0.device.type == "cpu":
        return fused_chunk_decode_plain(x0, h0, w, n_steps)
    if x0.device.type != "cuda":
        raise ValueError(f"no chunk decoder for device {x0.device}")
    return _launch(x0, h0, w, n_steps)


fused_chunk_decode.launches = 0
