"""Operations and bytes of the Gesture2Vec pipeline, from shapes alone.

Frozen copies: the analytic forward counts of the port's
`utils/flops.py` (1 multiply-add = 2 operations, the matmul structure),
and the least-work bounds of the card's kernels as the port's
`chip_smoke.py` states them (each input byte read once, each output byte
written once, fp32). `tests/test_portbench_work.py` holds these copies
equal to the originals at the benchmark's widths. The counts take the
work that the inputs need: real windows, chunks and frames, never the
padding a batch carries.
"""
from __future__ import annotations

from typing import Tuple


# ------------------------------------------------ analytic forward counts
def dense_flops(batch: int, in_dim: int, out_dim: int) -> float:
    return 2.0 * batch * in_dim * out_dim


def gru_cell_flops(batch: int, in_dim: int, hidden: int) -> float:
    """One GRU step, one direction: the input and hidden projections and
    ~9H elementwise gate operations."""
    return (dense_flops(batch, in_dim, 3 * hidden)
            + dense_flops(batch, hidden, 3 * hidden)
            + 9.0 * batch * hidden)


def gru_flops(batch: int, seq: int, in_dim: int, hidden: int,
              n_layers: int, bidirectional: bool = False) -> float:
    d = 2 if bidirectional else 1
    total = d * seq * gru_cell_flops(batch, in_dim, hidden)
    for _ in range(1, n_layers):
        total += d * seq * gru_cell_flops(batch, d * hidden, hidden)
    return total


def seq_ae_forward_flops(batch: int, n_frames: int, rep: int, hidden: int,
                         n_layers: int, codes: int) -> float:
    """The Part-b tokenizer's forward (BiGRU encoder, GS-Soft VQ,
    n_frames - 1 teacher-forced decoder steps)."""
    f = dense_flops(batch * n_frames, rep, hidden)
    f += gru_flops(batch, n_frames, hidden, hidden, n_layers,
                   bidirectional=True)
    lh = n_layers * hidden
    f += dense_flops(batch, lh, lh)            # mean_layer
    f += dense_flops(batch, lh, codes)         # logvar_layer
    f += 2.0 * batch * codes * lh              # distances
    f += 2.0 * batch * codes * lh              # soft assignment
    steps = n_frames - 1
    f += steps * dense_flops(batch, rep, hidden)
    f += steps * gru_flops(batch, 1, hidden, hidden, n_layers)
    f += steps * dense_flops(batch, hidden, rep)
    return f


def tcn_text2token_flops(batch: int, max_words: int, embed: int,
                         hidden: int, n_layers: int, n_steps: int,
                         codes: int, kernel: int = 2) -> float:
    """Part d with the TCN text encoder and the attention GRU decoder,
    n_steps - 1 decode steps a window."""
    f, in_ch = 0.0, embed
    for _ in range(n_layers):
        f += 2.0 * batch * max_words * kernel * in_ch * hidden
        f += 2.0 * batch * max_words * kernel * hidden * hidden
        if in_ch != hidden:
            f += dense_flops(batch * max_words, in_ch, hidden)
        in_ch = hidden
    f += dense_flops(batch * max_words, hidden, hidden)
    f += dense_flops(batch, hidden, n_layers * hidden)
    steps = n_steps - 1
    f += steps * (dense_flops(batch * max_words, 2 * hidden, hidden)
                  + 2.0 * batch * max_words * hidden
                  + 2.0 * batch * max_words * hidden
                  + dense_flops(batch, 2 * hidden, hidden)
                  + gru_flops(batch, 1, hidden, hidden, n_layers)
                  + dense_flops(batch, hidden, codes))
    return f


# ------------------------------------------------ kernel bounds (fp32)
def chunk_decoder_work(B: int, D: int, H: int, T: int
                       ) -> Tuple[float, float]:
    """(operations, bytes) of a rollout of B chunks over T steps: the
    seeds and the hidden in, the folded weights once, the frames out."""
    flops = 2.0 * B * T * (D * H + 2 * 2 * H * 3 * H + H * D)
    weights = D * H + 2 * H + 2 * (2 * H * 3 * H + 2 * 3 * H) + H * D + D
    nbytes = 4.0 * (B * D + 2 * B * H + weights + T * B * D)
    return flops, nbytes


def gru_forward_work(T: int, B: int, H: int) -> Tuple[float, float]:
    """The recurrent products; x_proj, h0, w_hh, b_hh in, outputs and
    the last hidden out."""
    return (2.0 * T * B * H * 3 * H,
            4.0 * (T * B * 3 * H + B * H + 3 * H * H + 3 * H
                   + T * B * H + B * H))


def gru_gates_work(T: int, B: int, H: int) -> Tuple[float, float]:
    """The training forward: `gru_forward_work` with the saved gates
    (T, B, 4H) written too."""
    flops, nbytes = gru_forward_work(T, B, H)
    return flops, nbytes + 4.0 * T * B * 4 * H


def gru_backward_work(T: int, B: int, H: int) -> Tuple[float, float]:
    """The backward's one product a step, dgh @ w_hh; the saved gates,
    h0, w_hh, ys, dys and dh_last in, d x_proj, dgh and d h0 out."""
    return (2.0 * T * B * 3 * H * H,
            4.0 * (T * B * 4 * H + 2 * B * H + 3 * H * H
                   + 2 * T * B * H + 2 * T * B * 3 * H + B * H))


# ------------------------------------------------ a cell's model step
def generation_flops(cfg: dict, windows: int, chunks: int,
                     frames: int) -> float:
    """The model operations of generating `windows` real windows: the
    TCN token model, the chunk rollout of their chunks, the DAE decode of
    their frames."""
    H, L, K = cfg["hidden_size"], cfg["n_layers"], cfg["codes"]
    n_steps = cfg["sentence_frame_length"] // cfg["n_poses"]
    kw = dict(max_words=cfg["max_words"], embed=cfg["wordembed_dim"],
              hidden=H, n_layers=L, n_steps=n_steps, codes=K)
    f = tcn_text2token_flops(windows, **kw)
    f += chunk_decoder_work(chunks, cfg["dae_latent"], H,
                            cfg["n_poses"])[0]
    f += dense_flops(frames, cfg["dae_latent"], cfg["pose_dim"])
    return f


def train_b_flops(cfg: dict, steps: int) -> float:
    """3x the tokenizer's analytic forward a step (forward and the
    backward's two products), over the steps."""
    return 3.0 * steps * seq_ae_forward_flops(
        cfg["batch_size"], cfg["n_poses"], cfg["dae_latent"],
        cfg["hidden_size"], cfg["n_layers"], cfg["codes"])
