"""The recommended recipe's generation path in plain PyTorch, and the
comparison that judges what the program generated.

The recipe (`configs/g2v_recipe.json`): the transformer Part d with
four stage-conditional heads, the 4-stage residual-VQ tokenizer's
decoder, the DAE, a sampled primary token and greedy residual stages.
The weights are the benchmark's (`weight_spec`), named as the port's
modules name them. The word windows, the chunk rollout, the DAE decode
and the unnormalise are `reference/g2v.py`'s. Here:

  the encoder   word embeddings -> embed_proj -> + sinusoidal positions
                -> pre-LN blocks (self-attention masked to the window's
                own words, GELU MLP) -> final LayerNorm;
  the decoder   one causal teacher-forced pass over each window's input
                buffer (the carried seed, then the program's tokens of
                steps 1 .. n_steps - 2), with cross-attention to the
                window's own words: position j gives the logits of step
                j + 1. The program instead re-runs its buffer step by
                step and reads one position a step; under the causal
                mask the two are the same function;
  the chain     the stage-conditional heads fed the program's codes:
                h_0 = the decoder output, h_{s+1} = h_s + stage_embed_s
                (code of stage s), stage s + 1's logits = out_layer_r{s+1}
                (h_{s+1});
  the hidden    each chunk's initial hidden is the sum of its codebook
                rows, one a stage; a window's seed step has no residual
                codes (the program marks them -1) and takes the stage-0
                row alone.

The choice at a step is the argmax of its decision scores: the logits /
temperature + the program's own Gumbel noise where the stage is
sampled, the logits where it is greedy (temperature 0). The judge
follows the program's tokens and codes (teacher forcing), so a near tie
that rounding decides differently is judged by its margin, not by
identity:

  token_gap   the widest gap by which a choice of the program (the
              primary token and each residual code, every real window,
              every decoded step) lies below the reference's best
              decision score there;
  latent_err  the chunk rollout's largest difference from the
              reference, over the reference's largest magnitude;
  frame_err   the same for the unnormalised frames;
  mismatch    answers of the wrong shape, window seeds that are not the
              carried tokens, seed steps that carry residual codes (an
              exact count).

The model's conventions as the port defines them (`models/transformer`)
and the JAX package before it, each a departure from the published
transformer (Vaswani et al., 2017): LayerNorm before each sub-layer
(pre-LN) and after the last block, epsilon 1e-6; the tanh approximation
of GELU; masked attention scores set to -1e30, not -inf; the word
embeddings projected to the hidden size before the positions are added;
no scaling of the embeddings by sqrt(hidden). `judge(control=True)`
reads the same reference in TF32 put in the program's place: the step
below the configuration's float32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from portbench.harness.weights import Spec, fan_in, group, normal
from portbench.reference import g2v as base
from portbench.reference.g2v import linear, tf32

LN_EPS = 1e-6
MASKED = -1e30


# ------------------------------------------------------------ weights
def _ln(p: str, n: int) -> Spec:
    return [(f"{p}.weight", (n,), normal(0.1, 1.0)),
            (f"{p}.bias", (n,), normal(0.1))]


def _mha(p: str, H: int) -> Spec:
    out: Spec = []
    for x in "qkvo":
        out += base._dense(f"{p}.{x}", H, H)
    return out


def _block(p: str, H: int, cross: bool) -> Spec:
    out = _ln(f"{p}.ln_self", H) + _mha(f"{p}.self_attn", H)
    if cross:
        out += _ln(f"{p}.ln_cross", H) + _mha(f"{p}.cross_attn", H)
    return (out + _ln(f"{p}.ln_mlp", H) + base._dense(f"{p}.mlp_in", H, 4 * H)
            + base._dense(f"{p}.mlp_out", 4 * H, H))


def _transformer_t2t(cfg: dict) -> Spec:
    H, L, E, K = (cfg["hidden_size"], cfg["n_layers"], cfg["wordembed_dim"],
                  cfg["codes"])
    out: Spec = [("encoder.embedding_table.weight", (cfg["n_words"], E),
                  normal(1.0))]
    out += base._dense("encoder.embed_proj", E, H)
    for i in range(L):
        out += _block(f"encoder.layer_{i}", H, cross=False)
    out += _ln("encoder.final_ln", H)
    out += [("decoder.token_embedding.weight", (K, H), normal(1.0))]
    for i in range(L):
        out += _block(f"decoder.layer_{i}", H, cross=True)
    out += _ln("decoder.final_ln", H) + base._dense("decoder.out_layer", H, K)
    for s in range(cfg["token_stages"] - 1):
        out += base._dense(f"decoder.out_layer_r{s + 1}", H, K)
        if cfg["stage_conditional"]:
            out += [(f"decoder.stage_embed_{s}.weight", (K, H), normal(1.0))]
    return out


def weight_spec(cfg: dict) -> Spec:
    """Every tensor of the recipe's generation path: `t2t.` the
    transformer Part d, `seq.` the tokenizer's decoder (a codebook a
    stage and the decoder step), `dae.` the DAE, `pose.` the corpus
    statistics that unnormalise frames."""
    H, L, K, D = (cfg["hidden_size"], cfg["n_layers"], cfg["codes"],
                  cfg["dae_latent"])
    seq: Spec = [("codebook", (K, L * H), normal(0.5))]
    seq += [(f"codebook_r{s}", (K, L * H), normal(0.2))
            for s in range(1, cfg["tokenizer_stages"])]
    seq += base._decoder_step("decoder_step", D, H, L, D)
    dae = base._dense("encoder", cfg["pose_dim"], D) \
        + base._dense("decoder", D, cfg["pose_dim"])
    pose = [("mean", (cfg["pose_dim"],), normal(0.3)),
            ("std", (cfg["pose_dim"],), ("uniform", 0.5, 1.5))]
    return ([("t2t." + n, s, i) for n, s, i in _transformer_t2t(cfg)]
            + [("seq." + n, s, i) for n, s, i in seq]
            + [("dae." + n, s, i) for n, s, i in dae]
            + [("pose." + n, s, i) for n, s, i in pose])


# ------------------------------------------------------------ layers
def layer_norm(x, W, p):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * W[p + ".weight"] \
        + W[p + ".bias"]


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def positions(length: int, dim: int, device) -> torch.Tensor:
    """The sinusoidal table (length, dim): sin on even columns, cos on
    odd, angle pos / 10000^(2 floor(i / 2) / dim), in float32."""
    pos = np.arange(length, dtype=np.float32)[:, None]
    i = np.arange(dim, dtype=np.float32)[None, :]
    angle = pos / np.power(10000.0, (2.0 * (i // 2)) / dim)
    table = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.from_numpy(table.astype(np.float32)).to(device)


def attention(q_in, kv_in, mask, W, p, n_heads):
    """q_in (N, Tq, H), kv_in (N, Tk, H), mask broadcastable to (N, 1,
    Tq, Tk), True where a query attends -> (N, Tq, H)."""
    N, Tq, H = q_in.shape
    hd = H // n_heads

    def heads(x):
        return x.reshape(N, x.shape[1], n_heads, hd).transpose(1, 2)

    q = heads(linear(q_in, W, p + ".q"))
    k = heads(linear(kv_in, W, p + ".k"))
    v = heads(linear(kv_in, W, p + ".v"))
    scores = (q @ k.transpose(-1, -2) / math.sqrt(hd)).masked_fill(
        ~mask, MASKED)
    out = (torch.softmax(scores, -1) @ v).transpose(1, 2).reshape(N, Tq, H)
    return linear(out, W, p + ".o")


def block(x, mask, W, p, n_heads, enc=None, enc_mask=None):
    h = layer_norm(x, W, p + ".ln_self")
    x = x + attention(h, h, mask, W, p + ".self_attn", n_heads)
    if enc is not None:
        x = x + attention(layer_norm(x, W, p + ".ln_cross"), enc, enc_mask,
                          W, p + ".cross_attn", n_heads)
    h = gelu_tanh(linear(layer_norm(x, W, p + ".ln_mlp"), W, p + ".mlp_in"))
    return x + linear(h, W, p + ".mlp_out")


# ------------------------------------------------------------ the model
def encode(cfg, W, ids, lengths):
    """ids (N, S), lengths (N,) -> (the words' encoding (N, S, H), the
    mask of each window's own words (N, S))."""
    S, L = ids.shape[1], cfg["n_layers"]
    x = linear(W["encoder.embedding_table.weight"][ids], W,
               "encoder.embed_proj")
    x = x + positions(S, x.shape[-1], x.device)
    valid = torch.arange(S, device=ids.device)[None, :] < lengths[:, None]
    for i in range(L):
        x = block(x, valid[:, None, None, :], W, f"encoder.layer_{i}",
                  cfg["t2t_heads"])
    return layer_norm(x, W, "encoder.final_ln"), valid


def decode(cfg, W, buf, enc, valid):
    """One causal teacher-forced pass: buf (N, T) the input tokens ->
    (logits (N, T, K), the decoder output (N, T, H)); position j gives
    the logits of step j + 1."""
    T = buf.shape[1]
    x = W["decoder.token_embedding.weight"][buf]
    x = x + positions(T, x.shape[-1], x.device)
    causal = torch.ones((T, T), dtype=torch.bool,
                        device=buf.device).tril()[None, None]
    for i in range(cfg["n_layers"]):
        x = block(x, causal, W, f"decoder.layer_{i}", cfg["t2t_heads"],
                  enc, valid[:, None, None, :])
    x = layer_norm(x, W, "decoder.final_ln")
    return linear(x, W, "decoder.out_layer"), x


def chain(cfg, W, out, first, codes):
    """The stage-conditional heads over the decoder output out (N, T, H),
    fed the primary tokens first (N, T) and the residual codes codes (N,
    T, S-1) -> the residual stages' logits (N, T, S-1, K)."""
    h, prev, logits = out, first, []
    for s in range(cfg["token_stages"] - 1):
        if cfg["stage_conditional"]:
            h = h + W[f"decoder.stage_embed_{s}.weight"][prev]
        logits.append(linear(h, W, f"decoder.out_layer_r{s + 1}"))
        prev = codes[..., s]
    return torch.stack(logits, -2)


def scores(logits, temperature: float, gumbel: Optional[torch.Tensor]):
    """The decision scores: the logits at temperature 0, else logits /
    temperature + the noise."""
    return logits if temperature <= 0.0 else logits / temperature + gumbel


def chunk_hidden(cfg, W, tokens, stages):
    """tokens (N,), stages (N, S-1) with -1 where a chunk has no residual
    code -> the decoder's initial hidden (L, N, H): the sum of the
    chunk's codebook rows."""
    flat = W["codebook"][tokens]
    for s in range(stages.shape[1]):
        st = stages[:, s]
        row = W[f"codebook_r{s + 1}"][st.clamp(min=0)]
        flat = flat + torch.where((st >= 0)[:, None], row,
                                  torch.zeros_like(row))
    return flat.reshape(-1, cfg["n_layers"], cfg["hidden_size"]).transpose(
        0, 1)


# ------------------------------------------------------------ the judge
class Answer(base.Answer):
    """`reference/g2v.Answer` with the residual codes (n_win * n_steps,
    S-1), -1 at each window's seed step, and the Gumbel noise the
    program drew for the transcript's real windows (n_win, n_steps - 1,
    token_stages, K), None where the decode is greedy."""

    def __init__(self, tokens, stages, noise, latents, frames,
                 consistent=True):
        super().__init__(tokens, latents, frames, consistent)
        self.stages, self.noise = stages, noise


def _gap(sc, pick):
    return float((sc.max(-1).values
                  - sc.gather(-1, pick[..., None])[..., 0]).max())


@torch.no_grad()
def judge(cfg: dict, weights: dict, transcripts: Sequence[list],
          durations: Sequence[float], answers: Sequence[Answer], device,
          control: bool = False) -> Dict[str, float]:
    """The readings of the program's answers (control=False), or of the
    reference in TF32 put in the program's place at the same prompts,
    tokens, codes and noise (control=True)."""
    T = cfg["sentence_frame_length"] // cfg["n_poses"]
    Fr, D, S1 = cfg["n_poses"], cfg["dae_latent"], cfg["token_stages"] - 1
    t0 = cfg["stage0_temperature"] if cfg["stage0_temperature"] >= 0.0 \
        else cfg["temperature"]
    temps = [t0] + [cfg["temperature"]] * S1
    W_t2t, W_seq = group(weights, "t2t"), group(weights, "seq")
    W_dae, W_pose = group(weights, "dae"), group(weights, "pose")
    std = W_pose["std"].clamp(min=base.STD_CLIP)
    out = {"token_gap": 0.0, "latent_err": 0.0, "frame_err": 0.0,
           "mismatch": 0}
    if len(answers) != len(transcripts):
        out["mismatch"] = abs(len(answers) - len(transcripts)) or 1
        return out
    sampled = any(t > 0.0 for t in temps)
    lat_num = lat_den = fr_num = fr_den = 0.0
    for words, dur, ans in zip(transcripts, durations, answers):
        ids, lengths = base.window_words(cfg, words, dur)
        n_win = ids.shape[0]
        rows = n_win * T * Fr
        noise_shape = (n_win, T - 1, S1 + 1, cfg["codes"])
        shapes = (ans.tokens.shape == (n_win * T,)
                  and tuple(ans.stages.shape) == (n_win * T, S1)
                  and (ans.noise is None) != sampled
                  and (ans.noise is None
                       or tuple(ans.noise.shape) == noise_shape)
                  and (ans.latents is None
                       or ans.latents.shape == (rows, D))
                  and ans.frames.shape == (rows, cfg["pose_dim"]))
        if not (shapes and ans.consistent):
            out["mismatch"] += 1
            continue
        inp, bad = base._inputs(cfg, ans.tokens.astype(np.int64), n_win)
        tok = torch.from_numpy(ans.tokens.astype(np.int64)).to(device)
        tok = tok.reshape(n_win, T)
        st = torch.as_tensor(ans.stages, device=device).long().reshape(
            n_win, T, S1)
        # a seed step carries no residual code, every other step one
        # of the codebook's
        bad += int((st[:, 0] != -1).sum())
        bad += int(((st[:, 1:] < 0) | (st[:, 1:] >= cfg["codes"])).sum())
        out["mismatch"] += bad
        st = st.clamp(min=0)
        for w0 in range(0, n_win, base.BLOCK_WINDOWS):
            sl = slice(w0, w0 + base.BLOCK_WINDOWS)
            args = (torch.from_numpy(ids[sl]).to(device),
                    torch.from_numpy(lengths[sl]).to(device))
            buf = torch.from_numpy(inp[sl]).to(device)
            first, codes = tok[sl, 1:], st[sl, 1:]
            noise = None if ans.noise is None else torch.as_tensor(
                ans.noise[sl], device=device).float()

            def decision(precise: bool):
                """Each stage's decision scores (N, T-1, K), stage by
                stage."""
                with tf32(not precise):
                    enc, valid = encode(cfg, W_t2t, *args)
                    lg, dec = decode(cfg, W_t2t, buf, enc, valid)
                    slg = chain(cfg, W_t2t, dec, first, codes)
                every = torch.cat([lg[:, :, None], slg], 2)
                return [scores(every[:, :, s], temps[s],
                               None if noise is None else noise[:, :, s])
                        for s in range(S1 + 1)]

            ref_scores = decision(True)
            picks = [first] + [codes[..., s] for s in range(S1)]
            if control:
                picks = [sc.argmax(-1) for sc in decision(False)]
            for sc, pick in zip(ref_scores, picks):
                out["token_gap"] = max(out["token_gap"], _gap(sc, pick))
        stages = torch.cat([torch.full_like(st[:, :1], -1), st[:, 1:]], 1)

        def rolled(precise: bool):
            with tf32(not precise):
                lat = base.rollout(cfg, W_seq, chunk_hidden(
                    cfg, W_seq, tok.reshape(-1),
                    stages.reshape(-1, S1))).reshape(rows, D)
                return lat, linear(lat, W_dae, "decoder") * std \
                    + W_pose["mean"]

        lat, frames = rolled(True)
        if control:
            got_lat, got_fr = rolled(False)
        else:
            got_lat = None if ans.latents is None else torch.as_tensor(
                ans.latents, device=device).float()
            got_fr = torch.as_tensor(ans.frames, device=device).float()
        if got_lat is not None:
            lat_num = max(lat_num, float((got_lat - lat).abs().max()))
            lat_den = max(lat_den, float(lat.abs().max()))
        fr_num = max(fr_num, float((got_fr - frames).abs().max()))
        fr_den = max(fr_den, float(frames.abs().max()))
    out["latent_err"] = lat_num / max(lat_den, 1e-30)
    out["frame_err"] = fr_num / max(fr_den, 1e-30)
    return out
