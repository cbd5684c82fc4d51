"""FLOP accounting: analytic model counts, the card's peaks and
PyTorch's operator count (the port's copy of the JAX package's
`utils/flops.py`).

Two complementary views:
  - counted_flops(fn, *args): the FLOPs of the PyTorch operators one call
    runs, from `torch.utils.flop_counter.FlopCounterMode` (matmuls,
    convolutions, attention; elementwise operators count 0). A kernel
    launched through ctypes (`ops/build.py`: the chunk decoder, the GRU
    sequence and its backward, the VQ argmin) is invisible to it, so the
    count means something on the CPU's plain path only; on the card it
    misses every hand-written kernel's work. It takes the place of the
    JAX package's `xla_flops` (XLA's cost model), which has no torch
    counterpart.
  - analytic forward counts for the pipeline models, from the matmul
    structure (1 MAC = 2 FLOPs), the same formulas as the JAX package's.
    These are the textbook denominators for utilization claims.

MFU reference: NVIDIA's data-sheet peaks of one H100 SXM at its 700 W
power limit (dense, without sparsity): 989 TFLOP/s bf16 on the tensor
cores, 495 TFLOP/s TF32, 67 TFLOP/s fp32 on the CUDA cores, and
3.35 TB/s of HBM3. A card set below 700 W runs slower under load, so a
share is read against the card's `power.limit` as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
it, written beside the share.
"""
from __future__ import annotations

H100_PEAK_BF16 = 989e12    # FLOP/s, tensor cores, dense
H100_PEAK_TF32 = 495e12    # FLOP/s, tensor cores, dense
H100_PEAK_FP32 = 67e12     # FLOP/s, CUDA cores
H100_PEAK_BYTES_S = 3.35e12  # HBM3 bytes/s


def counted_flops(fn, *args, **kwargs) -> float:
    """The FLOPs of the PyTorch operators one call of fn(*args, **kwargs)
    runs (`FlopCounterMode`). Kernels launched through ctypes are not
    counted: hold it against an analytic count on the CPU's plain path."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def mfu(flops_per_step: float, seconds_per_step: float,
        peak: float = H100_PEAK_BF16) -> float:
    """Model FLOPs utilization as a fraction of peak. The default peak is
    the bf16 tensor-core rate: the port's fp32 paths run on the CUDA cores
    today, so their share against 989 TFLOP/s is small by design (pass
    H100_PEAK_FP32 for their share of the CUDA cores' rate)."""
    if seconds_per_step <= 0:
        return 0.0
    return flops_per_step / seconds_per_step / peak


# -------------------------------------------------------- analytic counts
def dense_flops(batch: int, in_dim: int, out_dim: int) -> float:
    return 2.0 * batch * in_dim * out_dim


def gru_cell_flops(batch: int, in_dim: int, hidden: int) -> float:
    """One GRU step, one direction: input proj (3H x in) + hidden proj
    (3H x H) + ~9H elementwise gate ops."""
    return (dense_flops(batch, in_dim, 3 * hidden)
            + dense_flops(batch, hidden, 3 * hidden)
            + 9.0 * batch * hidden)


def gru_flops(batch: int, seq: int, in_dim: int, hidden: int,
              n_layers: int, bidirectional: bool = False) -> float:
    """Multi-layer (bi)GRU over a sequence. Layer 0 consumes in_dim;
    upper layers consume hidden (x2 when bidirectional, directions
    concatenated like torch)."""
    d = 2 if bidirectional else 1
    total = d * seq * gru_cell_flops(batch, in_dim, hidden)
    upper_in = d * hidden
    for _ in range(1, n_layers):
        total += d * seq * gru_cell_flops(batch, upper_in, hidden)
    return total


def dae_forward_flops(batch: int, motion_dim: int = 135,
                      latent: int = 40) -> float:
    """DAE_Network forward (ref: DAE_model.py:22-114)."""
    return dense_flops(batch, motion_dim, latent) + \
        dense_flops(batch, latent, motion_dim)


def seq_ae_forward_flops(batch: int, n_frames: int = 20, rep: int = 40,
                         hidden: int = 200, n_layers: int = 2,
                         codes: int = 512,
                         encoder: str = "bigru") -> float:
    """SeqVQAutoencoder forward: in_layer + encoder (biGRU, or the
    parallel transformer variant, models/seq_encoder),
    GS-Soft VQ (mean/logvar projections + distance matrix), n_frames-1
    decoder steps (pre_linear + GRU stack + out_layer)."""
    f = dense_flops(batch * n_frames, rep, hidden)
    if encoder == "transformer":
        B, T, H = batch, n_frames, hidden
        per_blk = (4 * dense_flops(B * T, H, H)      # QKV + O
                   + 4.0 * B * T * T * H             # scores + apply
                   + dense_flops(B * T, H, 4 * H)
                   + dense_flops(B * T, 4 * H, H))
        f += n_layers * per_blk
        f += dense_flops(B, H, n_layers * H)          # hidden_proj
    else:
        f += gru_flops(batch, n_frames, hidden, hidden, n_layers,
                       bidirectional=True)
    lh = n_layers * hidden
    f += dense_flops(batch, lh, lh)            # vq mean_layer
    f += dense_flops(batch, lh, codes)         # vq logvar_layer
    f += 2.0 * batch * codes * lh              # distance matrix
    f += 2.0 * batch * codes * lh              # soft-assign matmul
    steps = n_frames - 1
    f += steps * dense_flops(batch, rep, hidden)           # pre_linear
    f += steps * gru_flops(batch, 1, hidden, hidden, n_layers)
    f += steps * dense_flops(batch, hidden, rep)           # out_layer
    return f


def text2token_forward_flops(batch: int, max_words: int = 32,
                             embed: int = 300, hidden: int = 200,
                             n_layers: int = 2, n_steps: int = 4,
                             codes: int = 512,
                             encoder: str = "tcn",
                             kernel: int = 2) -> float:
    """Text2Token forward: text encoder + n_steps-1 attention decoder
    steps (embed + attn energy + pre_linear + GRU + out)."""
    if encoder == "gru":
        f = gru_flops(batch, max_words, embed, hidden, n_layers,
                      bidirectional=True)
    else:  # TCN: 2 convs per block, n_layers blocks (+1x1 downsample)
        f = 0.0
        in_ch = embed
        for _ in range(n_layers):
            # conv1 maps in_ch -> hidden; conv2 maps hidden -> hidden
            # (models/tcn.py TemporalBlock) — they differ in input width
            # on block 0, so count them separately.
            f += 2.0 * batch * max_words * kernel * in_ch * hidden
            f += 2.0 * batch * max_words * kernel * hidden * hidden
            if in_ch != hidden:
                f += dense_flops(batch * max_words, in_ch, hidden)
            in_ch = hidden
        f += dense_flops(batch * max_words, hidden, hidden)  # out proj
        f += dense_flops(batch, hidden, n_layers * hidden)   # hidden head
    steps = n_steps - 1
    f += steps * (
        dense_flops(batch * max_words, 2 * hidden, hidden)  # attn energy
        + 2.0 * batch * max_words * hidden                  # v-dot
        + 2.0 * batch * max_words * hidden                  # context bmm
        + dense_flops(batch, 2 * hidden, hidden)            # pre_linear
        + gru_flops(batch, 1, hidden, hidden, n_layers)
        + dense_flops(batch, hidden, codes))                # out
    return f


def transformer_t2t_forward_flops(batch: int, max_words: int = 32,
                                  embed: int = 300, hidden: int = 200,
                                  n_layers: int = 2, n_steps: int = 4,
                                  codes: int = 512) -> float:
    """TransformerText2Token TRAIN forward (models/transformer): one
    parallel encoder pass over max_words positions + one parallel
    teacher-forced decoder pass over n_steps-1 positions. Attention
    score/apply matmuls are 4*B*Tq*Tk*H FLOPs total (2 each); MLP is
    4x expansion. The autoregressive EVAL rollout instead runs the
    decoder pass n_steps-1 times (multiply the decoder term
    accordingly)."""
    B, S, H, T = batch, max_words, hidden, n_steps - 1
    f = dense_flops(B * S, embed, H)                  # embed projection
    per_enc = (4 * dense_flops(B * S, H, H)           # QKV + O
               + 4.0 * B * S * S * H                  # scores + apply
               + dense_flops(B * S, H, 4 * H)
               + dense_flops(B * S, 4 * H, H))
    f += n_layers * per_enc
    per_dec = (4 * dense_flops(B * T, H, H)           # self QKV + O
               + 4.0 * B * T * T * H
               + 2 * dense_flops(B * T, H, H)         # cross Q + O
               + 2 * dense_flops(B * S, H, H)         # cross K + V
               + 4.0 * B * T * S * H
               + dense_flops(B * T, H, 4 * H)
               + dense_flops(B * T, 4 * H, H))
    f += n_layers * per_dec
    f += dense_flops(B * T, H, codes)                 # out layer
    return f


def e2e_decode_flops(n_tokens: int, n_frames: int = 20, rep: int = 40,
                     hidden: int = 200, n_layers: int = 2,
                     motion_dim: int = 135) -> float:
    """Decode-mode synthesis per generation: Part-b chunk rollout for
    every token + DAE decode for every output frame (token prediction
    is counted via text2token_forward_flops separately)."""
    steps = n_frames - 1
    f = n_tokens * steps * (dense_flops(1, rep, hidden)
                            + gru_flops(1, 1, hidden, hidden, n_layers)
                            + dense_flops(1, hidden, rep))
    f += dense_flops(n_tokens * n_frames, rep, motion_dim)
    return f
