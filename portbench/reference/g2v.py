"""Gesture2Vec's generation path in plain PyTorch, and the comparison
that judges what the program generated.

The weights are the benchmark's (`weight_spec`, made by
`harness/weights.make`), named as the port's modules name them. The
reference works out the rest itself: the word ids of every window, the
carried seeds, the encoders, the token decoders, the codebook rows of
each chunk, the chunk rollout, the DAE decode and the unnormalised
frames. The token model is the TCN encoder with the attention GRU
decoder (`configs/g2v_paper.json`). It follows the program's tokens (teacher forcing), so a near tie
that rounding decides differently is judged by its margin, not by
identity:

  token_gap   the widest gap by which a token the program chose lies
              below the reference's best logit at that step (every real
              window, every decoded step);
  latent_err  the chunk rollout's largest difference from the
              reference, over the reference's largest magnitude;
  frame_err   the same for the unnormalised frames;
  mismatch    answers of the wrong shape, window seeds that are not the
              carried tokens (an exact count).

Each runs in blocks of windows so that it fits beside the program's
peak. `judge(control=True)` reads the same reference in TF32 put in the
program's place: the step below the configuration's float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.harness.weights import Spec, const, fan_in, group, normal

SOS, EOS, UNK, N_SPECIAL = 1, 2, 3, 4
STD_CLIP = 0.01
BN_EPS = 1e-5
BLOCK_WINDOWS = 4096


# ------------------------------------------------------------ weights
def _dense(p: str, i: int, o: int) -> Spec:
    return [(f"{p}.weight", (o, i), fan_in(i)), (f"{p}.bias", (o,), fan_in(i))]


def _bn(p: str, n: int) -> Spec:
    return [(f"{p}.weight", (n,), normal(0.1, 1.0)),
            (f"{p}.bias", (n,), normal(0.1)),
            (f"{p}.running_mean", (n,), normal(0.1)),
            (f"{p}.running_var", (n,), ("uniform", 0.5, 1.5)),
            (f"{p}.num_batches_tracked", (), const(0))]


def _gru_cells(p: str, in_dim: int, H: int, L: int) -> Spec:
    out: Spec = []
    for layer in range(L):
        i = in_dim if layer == 0 else H
        out += [(f"{p}.l{layer}_w_ih", (3 * H, i), fan_in(H)),
                (f"{p}.l{layer}_w_hh", (3 * H, H), fan_in(H)),
                (f"{p}.l{layer}_b_ih", (3 * H,), fan_in(H)),
                (f"{p}.l{layer}_b_hh", (3 * H,), fan_in(H))]
    return out


def _decoder_step(p: str, in_dim: int, H: int, L: int, out_dim: int) -> Spec:
    return (_dense(f"{p}.pre_linear", in_dim, H) + _bn(f"{p}.pre_bn", H)
            + _gru_cells(f"{p}.gru", H, H, L)
            + _dense(f"{p}.out_layer", H, out_dim))


def _tcn_t2t(cfg: dict) -> Spec:
    H, L, E, K = (cfg["hidden_size"], cfg["n_layers"], cfg["wordembed_dim"],
                  cfg["codes"])
    out: Spec = [("encoder.embedding_table.weight", (cfg["n_words"], E),
                  normal(1.0))]
    for b in range(L):
        i = E if b == 0 else H
        p = f"encoder.tcn.blocks.{b}"
        for conv, c_in in (("conv1", i), ("conv2", H)):
            out += [(f"{p}.{conv}.kernel", (H, c_in, 2), normal(0.01)),
                    (f"{p}.{conv}.scale", (H,), normal(0.1, 1.0)),
                    (f"{p}.{conv}.bias", (H,), fan_in(2 * c_in))]
        if i != H:
            out += [(f"{p}.downsample.weight", (H, i, 1), fan_in(i)),
                    (f"{p}.downsample.bias", (H,), fan_in(i))]
    out += _dense("encoder.decoder", H, H) \
        + _dense("encoder.hidden_proj", H, L * H)
    s = "decoder_step"
    out += [(f"{s}.token_embedding.weight", (K, H), normal(1.0)),
            (f"{s}.attn.v", (H,), fan_in(H))]
    out += _dense(f"{s}.attn.attn", 2 * H, H)
    out += _decoder_step(s, 2 * H, H, L, K)
    return out


def weight_spec(cfg: dict) -> Spec:
    """Every tensor of the generation path: `t2t.` the Part-d model,
    `seq.` the tokenizer's decoder (codebooks and decoder step), `dae.`
    the DAE, `pose.` the corpus statistics that unnormalise frames."""
    H, L, K, D = (cfg["hidden_size"], cfg["n_layers"], cfg["codes"],
                  cfg["dae_latent"])
    t2t = _tcn_t2t(cfg)
    seq: Spec = [("codebook", (K, L * H), normal(0.5))]
    seq += _decoder_step("decoder_step", D, H, L, D)
    dae = _dense("encoder", cfg["pose_dim"], D) \
        + _dense("decoder", D, cfg["pose_dim"])
    pose = [("mean", (cfg["pose_dim"],), normal(0.3)),
            ("std", (cfg["pose_dim"],), ("uniform", 0.5, 1.5))]
    return ([("t2t." + n, s, i) for n, s, i in t2t]
            + [("seq." + n, s, i) for n, s, i in seq]
            + [("dae." + n, s, i) for n, s, i in dae]
            + [("pose." + n, s, i) for n, s, i in pose])


# ------------------------------------------------------------ inputs
def transcript(rng: np.random.Generator, duration_s: float, n_words: int,
               words_per_s: float) -> List[list]:
    """A timed transcript: evenly spaced 0.3 s words at words_per_s,
    each drawn from the vocabulary `w0 .. w{n}`."""
    n = max(int(words_per_s * duration_s), 1)
    starts = np.linspace(0.1, max(duration_s - 0.5, 0.1), n)
    ids = rng.integers(0, n_words - N_SPECIAL, size=n)
    return [[f"w{i}", float(s), float(s + 0.3)] for i, s in zip(ids, starts)]


def window_words(cfg: dict, words: List[list], duration_s: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids (W, max_words), lengths (W,)) of a transcript's real windows:
    the words overlapping each window, SOS and EOS around them, cut to
    max_words, zero-padded; length >= 1. Word `w{i}` has id 4 + i."""
    unit = cfg["sentence_frame_length"] / cfg["fps"]
    n_win = max(int(math.ceil(duration_s / unit)), 1)
    S = cfg["max_words"]
    starts = np.array([w[1] for w in words])
    ends = np.array([w[2] for w in words])
    wid = np.array([N_SPECIAL + int(w[0][1:]) for w in words])
    ids = np.zeros((n_win, S), np.int64)
    lengths = np.ones(n_win, np.int64)
    for w in range(n_win):
        lo = np.searchsorted(ends, w * unit, side="right")
        hi = np.searchsorted(starts, (w + 1) * unit, side="left")
        row = [SOS] + wid[lo:hi].tolist() + [EOS]
        row = row[:S]
        ids[w, :len(row)] = row
        lengths[w] = max(len(row), 1)
    return ids, lengths


# ------------------------------------------------------------ layers
def linear(x, W, p):
    return x @ W[p + ".weight"].t() + W[p + ".bias"]


def bn_eval(x, W, p):
    return (x - W[p + ".running_mean"]) / torch.sqrt(
        W[p + ".running_var"] + BN_EPS) * W[p + ".weight"] + W[p + ".bias"]


def gru_cell(x, h, W, p, layer):
    H = h.shape[-1]
    gi = x @ W[f"{p}.l{layer}_w_ih"].t() + W[f"{p}.l{layer}_b_ih"]
    gh = h @ W[f"{p}.l{layer}_w_hh"].t() + W[f"{p}.l{layer}_b_hh"]
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1.0 - z) * n + z * h


def gru_stack(x, h, W, p):
    new = []
    for layer in range(h.shape[0]):
        x = gru_cell(x, h[layer], W, p, layer)
        new.append(x)
    return torch.stack(new)


# ------------------------------------------------------------ token models
def _wn_conv(x, W, p, dilation):
    k = W[p + ".kernel"]
    w = k * torch.rsqrt((k * k).sum(dim=(1, 2), keepdim=True) + 1e-12) \
        * W[p + ".scale"][:, None, None]
    pad = (k.shape[-1] - 1) * dilation
    return F.conv1d(F.pad(x, (pad, 0)), w, W[p + ".bias"], dilation=dilation)


def tcn_logits(cfg, W, ids, lengths, inputs) -> torch.Tensor:
    """TCN encoder and the attention GRU decoder, each step fed its
    teacher input: ids (N, S), lengths (N,), inputs (N, T-1) -> logits
    (N, T-1, K)."""
    N, S = ids.shape
    L = cfg["n_layers"]
    x = W["encoder.embedding_table.weight"][ids].transpose(1, 2)
    for b in range(L):
        p = f"encoder.tcn.blocks.{b}"
        h = torch.relu(_wn_conv(x, W, p + ".conv1", 2 ** b))
        h = torch.relu(_wn_conv(h, W, p + ".conv2", 2 ** b))
        res = x if p + ".downsample.weight" not in W else F.conv1d(
            x, W[p + ".downsample.weight"], W[p + ".downsample.bias"])
        x = torch.relu(h + res)
    y = x.transpose(1, 2)                                   # (N, S, H)
    enc = linear(y, W, "encoder.decoder").transpose(0, 1)   # (S, N, H)
    last = y[torch.arange(N, device=y.device), (lengths - 1).clamp(0, S - 1)]
    hidden = linear(torch.tanh(last), W, "encoder.hidden_proj").reshape(
        N, L, -1).transpose(0, 1)
    mask = torch.arange(S, device=ids.device)[None, :] < lengths[:, None]
    s = "decoder_step"
    logits = []
    for t in range(inputs.shape[1]):
        x = W[f"{s}.token_embedding.weight"][inputs[:, t]]
        energy = torch.tanh(linear(torch.cat(
            [hidden[-1].unsqueeze(0).expand(S, -1, -1), enc], -1), W,
            f"{s}.attn.attn"))
        scores = (energy @ W[f"{s}.attn.v"]).t().masked_fill(
            ~mask, float("-inf"))
        ctx = torch.einsum("bt,tbh->bh", torch.softmax(scores, -1), enc)
        x = torch.relu(bn_eval(linear(torch.cat([x, ctx], -1), W,
                                      f"{s}.pre_linear"), W, f"{s}.pre_bn"))
        hidden = gru_stack(x, hidden, W, f"{s}.gru")
        logits.append(linear(hidden[-1], W, f"{s}.out_layer"))
    return torch.stack(logits, 1)


# ------------------------------------------------------------ chunks
def chunk_hidden(cfg, W, tokens):
    """(N,) tokens -> the decoder's initial hidden (L, N, H) from the
    codebook rows."""
    flat = W["codebook"][tokens]
    return flat.reshape(-1, cfg["n_layers"], cfg["hidden_size"]).transpose(
        0, 1)


def rollout(cfg, W, hidden):
    """n_poses frames from a zero seed frame, each output the next input:
    hidden (L, N, H) -> (N, n_poses, D)."""
    x = hidden.new_zeros((hidden.shape[1], cfg["dae_latent"]))
    outs = []
    for _ in range(cfg["n_poses"]):
        p = torch.relu(bn_eval(linear(x, W, "decoder_step.pre_linear"), W,
                               "decoder_step.pre_bn"))
        hidden = gru_stack(p, hidden, W, "decoder_step.gru")
        x = linear(hidden[-1], W, "decoder_step.out_layer")
        outs.append(x)
    return torch.stack(outs, 1)


# ------------------------------------------------------------ the judge
class Answer:
    """What the program gave for one transcript: its tokens (n_win *
    n_steps,), latents
    (n_win * n_steps * n_poses, D; None where the answer does not carry
    them) and frames (same rows, pose_dim);
    consistent is False where the tokens returned are not the tokens the
    chunks were decoded from."""

    def __init__(self, tokens, latents, frames, consistent=True):
        self.tokens = tokens
        self.latents, self.frames = latents, frames
        self.consistent = consistent


def _inputs(cfg, tokens: np.ndarray, n_win: int) -> Tuple[np.ndarray, int]:
    """The teacher inputs (n_win, T-1) of every window from the program's
    tokens (window seeds carried from the window before), and how many
    window seeds differ from the carried tokens."""
    T = cfg["sentence_frame_length"] // cfg["n_poses"]
    k = cfg["t2t_n_pre_poses"]
    tok = tokens.reshape(n_win, T)
    seeds = np.zeros((n_win, T), np.int64)
    seeds[1:, :k] = tok[:-1, T - k:]
    bad = int((tok[:, 0] != seeds[:, 0]).sum())
    inp = np.where(np.arange(T - 1)[None, :] < k, seeds[:, :T - 1],
                   tok[:, :T - 1])
    return inp, bad


@torch.no_grad()
def judge(cfg: dict, weights: dict, transcripts: Sequence[list],
          durations: Sequence[float], answers: Sequence[Answer], device,
          control: bool = False) -> Dict[str, float]:
    """The readings of the program's answers (control=False), or of the
    reference in TF32 put in the program's place at the same prompts and
    tokens (control=True)."""
    T = cfg["sentence_frame_length"] // cfg["n_poses"]
    Fr, D = cfg["n_poses"], cfg["dae_latent"]
    W_t2t, W_seq = group(weights, "t2t"), group(weights, "seq")
    W_dae, W_pose = group(weights, "dae"), group(weights, "pose")
    std = W_pose["std"].clamp(min=STD_CLIP)
    out = {"token_gap": 0.0, "latent_err": 0.0, "frame_err": 0.0,
           "mismatch": 0}
    if len(answers) != len(transcripts):
        out["mismatch"] = abs(len(answers) - len(transcripts)) or 1
        return out
    lat_num = lat_den = fr_num = fr_den = 0.0
    for words, dur, ans in zip(transcripts, durations, answers):
        ids, lengths = window_words(cfg, words, dur)
        n_win = ids.shape[0]
        rows = n_win * T * Fr
        shapes = (ans.tokens.shape == (n_win * T,)
                  and (ans.latents is None
                       or ans.latents.shape == (rows, D))
                  and ans.frames.shape == (rows, cfg["pose_dim"]))
        if not (shapes and ans.consistent):
            out["mismatch"] += 1
            continue
        inp, bad = _inputs(cfg, ans.tokens.astype(np.int64), n_win)
        out["mismatch"] += bad
        tok = torch.from_numpy(ans.tokens.astype(np.int64)).to(device)
        tok = tok.reshape(n_win, T)
        for w0 in range(0, n_win, BLOCK_WINDOWS):
            sl = slice(w0, w0 + BLOCK_WINDOWS)
            args = (cfg, W_t2t, torch.from_numpy(ids[sl]).to(device),
                    torch.from_numpy(lengths[sl]).to(device),
                    torch.from_numpy(inp[sl]).to(device))
            with tf32(False):
                lg = tcn_logits(*args)
            pick = tok[sl, 1:]
            if control:
                with tf32(True):
                    pick = tcn_logits(*args).argmax(-1)
            gap = lg.max(-1).values - lg.gather(-1, pick[..., None])[..., 0]
            out["token_gap"] = max(out["token_gap"], float(gap.max()))
        with tf32(False):
            lat = rollout(cfg, W_seq, chunk_hidden(
                cfg, W_seq, tok.reshape(-1))).reshape(rows, D)
            frames = linear(lat, W_dae, "decoder") * std + W_pose["mean"]
        if control:
            with tf32(True):
                got_lat = rollout(cfg, W_seq, chunk_hidden(
                    cfg, W_seq, tok.reshape(-1))).reshape(rows, D)
                got_fr = linear(got_lat, W_dae, "decoder") * std \
                    + W_pose["mean"]
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


class tf32:
    """TF32 for matmuls and convolutions on (True) or off (False) inside
    the block; the previous settings after it."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
