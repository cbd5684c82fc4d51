"""Operations of the recommended recipe's generation, from shapes alone.

A frozen copy of the port's analytic count of the transformer Part d
(`utils/flops.transformer_t2t_forward_flops`: one encoder pass over the
words, one decoder pass over the n_steps - 1 positions, 1 multiply-add =
2 operations), with the residual stages' heads added. It counts the work
the inputs need: each decoder position once, as a cached decode computes
it, not the n_steps - 1 passes over the whole buffer that the program's
uncached decode runs. `tests/test_torch_port_recipe_bench.py` holds the
copy equal to the original.
"""
from __future__ import annotations

from portbench.work.g2v import chunk_decoder_work, dense_flops


def transformer_t2t_flops(batch: int, max_words: int, embed: int,
                          hidden: int, n_layers: int, n_steps: int,
                          codes: int) -> float:
    """The transformer Part d's encoder and decoder over `batch`
    windows: QKV and O projections, scores and their application (4 B Tq
    Tk H), the 4x MLP; the cross-attention's K and V over the words; the
    output head."""
    B, S, H, T = batch, max_words, hidden, n_steps - 1
    f = dense_flops(B * S, embed, H)
    per_enc = (4 * dense_flops(B * S, H, H)
               + 4.0 * B * S * S * H
               + dense_flops(B * S, H, 4 * H)
               + dense_flops(B * S, 4 * H, H))
    f += n_layers * per_enc
    per_dec = (4 * dense_flops(B * T, H, H)
               + 4.0 * B * T * T * H
               + 2 * dense_flops(B * T, H, H)
               + 2 * dense_flops(B * S, H, H)
               + 4.0 * B * T * S * H
               + dense_flops(B * T, H, 4 * H)
               + dense_flops(B * T, 4 * H, H))
    f += n_layers * per_dec
    f += dense_flops(B * T, H, codes)
    return f


def generation_flops(cfg: dict, windows: int, chunks: int,
                     frames: int) -> float:
    """The model operations of generating `windows` real windows: the
    transformer Part d and its residual-stage heads (one a stage after
    the first, each position once), the chunk rollout of their chunks,
    the DAE decode of their frames."""
    H, K = cfg["hidden_size"], cfg["codes"]
    n_steps = cfg["sentence_frame_length"] // cfg["n_poses"]
    f = transformer_t2t_flops(windows, cfg["max_words"],
                              cfg["wordembed_dim"], H, cfg["n_layers"],
                              n_steps, K)
    f += (cfg["token_stages"] - 1) * dense_flops(windows * (n_steps - 1),
                                                 H, K)
    f += chunk_decoder_work(chunks, cfg["dae_latent"], H,
                            cfg["n_poses"])[0]
    f += dense_flops(frames, cfg["dae_latent"], cfg["pose_dim"])
    return f
