"""Gesture2Vec's Part-b training step in plain PyTorch, and the
comparison that judges the program's first steps.

The tokenizer (in_layer -> BiGRU, directions summed; GS-Soft VQ over the
first layer's two last states; a decoder step pre_linear -> BatchNorm on
batch statistics -> ReLU -> 2 GRU cells -> out_layer, fed the teacher's
first frame and then its own outputs for 19 steps), the reference's loss
(weighted L1 + continuity + variance, plus the VQ loss / 400), autograd,
optax's clip at global norm 5 and Adam(0.5, 0.999, 1e-8).

Dropout draws the same masks as the program: one torch.Generator on the
card, seeded as the program's, drawn in the program's order and shapes
(the encoder's input (T, B, D), the BiGRU's first-layer outputs
(T, B, 2H), then each decoder step's input (B, D) at the reference's
0.95 and its first GRU cell's output (B, H)). A different order or shape
in the program reads as a wrong loss.

The readings compared:
  loss_err     over the three checked steps, the largest |loss -
               reference loss| / |reference loss|;
  grad_err_median   the median leaf's gap between the norms of the first
               step's gradient as the optimizer got it (worked out from
               Adam's first moment) and the reference's, over the
               reference leaf's norm or the median leaf's, the larger;
  update_err_median the same for the parameters' change over the three
               steps (Adam's update).
The readings reported beside them: loss1_err (the first step's loss),
grad_err (the worst leaf), update1_err and update1_err_median (the first
step's change, worst and median leaf), update_err (the worst leaf's
change over the three steps). On the card a ReLU input within rounding
of 0 can land on the other side (the gradient of that element moves,
and BatchNorm spreads it over the batch) and Adam's epsilon turns the
rounding of gradient elements that cancel to about zero into whole
steps: the worst leaf's readings swing from seed to seed with them (see
PERF.md); the losses and the median leaf's gradient and change
separate the program from the planted faults.
Leaves whose reference gradient is under a thousandth of the median
leaf's (a bias that BatchNorm cancels moves by rounding alone) are left
out of the change readings and of the medians; the worst-leaf gradient
reading counts every leaf, a small one against the median leaf's norm.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.harness.weights import Spec, fan_in, normal
from portbench.reference.g2v import _bn, _dense, _gru_cells, tf32

BN_EPS = 1e-5
NEGLIGIBLE = 1e-3
ADAM_EPS = 1e-8


def weight_spec(cfg: dict) -> Spec:
    """The tokenizer's tensors, named as the port's SeqVQAutoencoder
    names them (its decoder's codebook is the quantizer's, one tensor)."""
    H, L, K, D = (cfg["hidden_size"], cfg["n_layers"], cfg["codes"],
                  cfg["dae_latent"])
    out = _dense("encoder.in_layer", D, H)
    for layer in range(L):
        i = H if layer == 0 else 2 * H
        for sfx in ("", "_reverse"):
            out += [(f"encoder.gru.l{layer}_w_ih{sfx}", (3 * H, i), fan_in(H)),
                    (f"encoder.gru.l{layer}_w_hh{sfx}", (3 * H, H), fan_in(H)),
                    (f"encoder.gru.l{layer}_b_ih{sfx}", (3 * H,), fan_in(H)),
                    (f"encoder.gru.l{layer}_b_hh{sfx}", (3 * H,), fan_in(H))]
    out += [("vq_layer.codebook", (K, L * H), normal(0.5))]
    out += _dense("vq_layer.mean_layer", L * H, L * H)
    out += _dense("vq_layer.logvar_layer", L * H, K)
    p = "decoder.decoder_step"
    out += _dense(f"{p}.pre_linear", D, H) + _bn(f"{p}.pre_bn", H) \
        + _gru_cells(f"{p}.gru", H, H, L) + _dense(f"{p}.out_layer", H, D)
    return out


def corpus(rng: np.random.Generator, n: int, frames: int, dim: int
           ) -> np.ndarray:
    """n windows (n, frames, dim) standing in for the frozen DAE's
    latents: non-negative (the DAE encodes through a ReLU) and smooth in
    time (a random walk around a per-window level)."""
    level = rng.normal(0.3, 0.5, size=(n, 1, dim))
    walk = np.cumsum(rng.normal(0.0, 0.05, size=(n, frames, dim)), axis=1)
    return np.maximum(level + walk, 0.0).astype(np.float32)


def batches(windows: np.ndarray, batch: int, seed: int):
    """The trainer's order: a permutation of the windows an epoch from
    np.random.default_rng(seed + epoch), full batches, epoch after
    epoch."""
    n = windows.shape[0]
    epoch = 0
    while True:
        perm = np.random.default_rng(seed + epoch).permutation(n)
        for b in range(n // batch):
            yield windows[perm[b * batch:(b + 1) * batch]]
        epoch += 1


# ------------------------------------------------------------ the step
def _drop(x, rate, gen):
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))


def _linear(x, P, p):
    return x @ P[p + ".weight"].t() + P[p + ".bias"]


def _cell(x, h, P, p, layer):
    H = h.shape[-1]
    gi = x @ P[f"{p}.l{layer}_w_ih"].t() + P[f"{p}.l{layer}_b_ih"]
    gh = h @ P[f"{p}.l{layer}_w_hh"].t() + P[f"{p}.l{layer}_b_hh"]
    r = torch.sigmoid(gi[:, :H] + gh[:, :H])
    z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1.0 - z) * n + z * h


def _gru_dir(xs, P, p, layer, sfx):
    """One direction of one BiGRU layer over (T, B, in): outputs at
    their time positions and the state after its last step."""
    names = {k: P[f"{p}.l{layer}_{k}{sfx}"]
             for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
    Q = {f"g.l0_{k}": v for k, v in names.items()}
    T = xs.shape[0]
    h = xs.new_zeros((xs.shape[1], names["w_hh"].shape[1]))
    ys = [None] * T
    order = range(T - 1, -1, -1) if sfx else range(T)
    for t in order:
        h = _cell(xs[t], h, Q, "g", 0)
        ys[t] = h
    return torch.stack(ys), h


def loss_of(cfg: dict, P: Dict[str, torch.Tensor], x: torch.Tensor,
            gen: torch.Generator) -> torch.Tensor:
    """The Part-b loss of a batch x (B, T, D) in training mode."""
    H, L = cfg["hidden_size"], cfg["n_layers"]
    rate = cfg["dropout_prob"]
    xs = _drop(x.transpose(0, 1), rate, gen)                 # (T, B, D)
    outs = _linear(xs, P, "encoder.in_layer")
    finals = []
    for layer in range(L):
        ys = []
        for sfx in ("", "_reverse"):
            y, h = _gru_dir(outs, P, "encoder.gru", layer, sfx)
            ys.append(y)
            finals.append(h)
        outs = torch.cat(ys, -1)
        if layer < L - 1:
            outs = _drop(outs, rate, gen)
    hidden = torch.stack(finals[:L])                          # (L, B, H)
    B = x.shape[0]
    flat = hidden.transpose(0, 1).reshape(B, L * H)
    cb = P["vq_layer.codebook"]
    proj = _linear(flat, P, "vq_layer.mean_layer")
    z_logvar = _linear(proj, P, "vq_layer.logvar_layer")
    d = (proj * proj).sum(-1, keepdim=True) + (cb * cb).sum(-1) \
        - 2.0 * proj @ cb.t()
    log_smooth = torch.clamp(-2.0 * z_logvar, -30.0, 30.0)
    logp = -(d / 400.0) * 0.5 * torch.exp(log_smooth) - 0.5 * log_smooth
    q = torch.softmax(logp, 1) @ cb
    vq_loss = torch.mean((q - flat.detach()) ** 2) \
        + cfg["vq_commitment_cost"] * torch.mean((q.detach() - flat) ** 2)
    st = flat + (q - flat).detach()
    h = st.reshape(B, L, H).transpose(0, 1)
    p = "decoder.decoder_step"
    prev, outs_dec = x[:, 0], [x[:, 0]]
    for t in range(1, x.shape[1]):
        inp = x[:, t - 1] if t - 1 < 1 else prev
        inp = _drop(inp, 0.95, gen)
        a = _linear(inp, P, f"{p}.pre_linear")
        mean = a.mean(0)
        c = a - mean
        var = (c * c).mean(0)
        a = torch.relu(c * torch.rsqrt(var + BN_EPS) * P[f"{p}.pre_bn.weight"]
                       + P[f"{p}.pre_bn.bias"])
        new = []
        for layer in range(L):
            a = _cell(a, h[layer], P, f"{p}.gru", layer)
            new.append(a)
            if layer < L - 1:
                a = _drop(a, rate, gen)
        h = torch.stack(new)
        prev = _linear(a, P, f"{p}.out_layer")
        outs_dec.append(prev)
    out = torch.stack(outs_dec, 1)
    n = out.numel()
    l1 = torch.mean(torch.abs(out - x)) * cfg["loss_l1_weight"]
    cont = torch.sum(torch.abs(out[:, 1:] - out[:, :-1])) / n \
        * cfg["loss_cont_weight"]
    var = -torch.sum(torch.linalg.vector_norm(out, ord=2, dim=1)) / n \
        * cfg["loss_var_weight"]
    return l1 + cont + var + vq_loss / 400.0


def reference_steps(cfg: dict, weights: Dict[str, torch.Tensor],
                    xs: Sequence[torch.Tensor], gen: torch.Generator,
                    names: Sequence[str]) -> dict:
    """The reference's steps over the batches xs, from the weights, the
    dropout stream gen (in the program's starting state). Returns the
    losses, the first step's clipped gradient and the parameters' change,
    by leaf name."""
    P = {n: weights[n].clone().requires_grad_(True) for n in names}
    start = {n: t.detach().clone() for n, t in P.items()}
    mu = {n: torch.zeros_like(t) for n, t in P.items()}
    nu = {n: torch.zeros_like(t) for n, t in P.items()}
    lr, b1, b2, eps = cfg["learning_rate"], 0.5, 0.999, ADAM_EPS
    losses, first = [], None
    for count, x in enumerate(xs, start=1):
        loss = loss_of(cfg, P, x, gen)
        grads = torch.autograd.grad(loss, [P[n] for n in names],
                                    allow_unused=True)
        g = {n: (gr if gr is not None else torch.zeros_like(P[n]))
             for n, gr in zip(names, grads)}
        norm = torch.sqrt(sum((v * v).sum() for v in g.values()))
        scale = 1.0 if float(norm) < 5.0 else 5.0 / norm
        g = {n: v * scale for n, v in g.items()}
        if first is None:
            first = {n: v.detach().clone() for n, v in g.items()}
        with torch.no_grad():
            for n in names:
                mu[n] = b1 * mu[n] + (1 - b1) * g[n]
                nu[n] = b2 * nu[n] + (1 - b2) * g[n] * g[n]
                m_hat = mu[n] / (1 - b1 ** count)
                v_hat = nu[n] / (1 - b2 ** count)
                P[n] -= lr * m_hat / (torch.sqrt(v_hat) + eps)
        if count == 1:
            change1 = {n: (P[n].detach() - start[n]) for n in names}
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad": first, "change1": change1,
            "change": {n: (P[n].detach() - start[n]) for n in names}}


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              counted: Sequence[str]) -> Dict[str, float]:
    """Each counted leaf's gap between the norms, over the reference
    leaf's norm or the median leaf's, the larger."""
    norms = {n: float(torch.linalg.vector_norm(want[n])) for n in counted}
    floor = float(np.median(list(norms.values())))
    return {n: abs(float(torch.linalg.vector_norm(got[n])) - norms[n])
            / max(norms[n], floor) for n in counted}


def judge(program: dict, reference: dict) -> Dict[str, float]:
    """The readings of the program's three checked steps against the
    reference's (see the module note)."""
    grads = {n: float(torch.linalg.vector_norm(v))
             for n, v in reference["grad"].items()}
    median = float(np.median(list(grads.values())))
    counted = [n for n, v in grads.items() if v >= NEGLIGIBLE * median]
    loss_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in
                   zip(program["losses"], reference["losses"]))
    if len(program["losses"]) != len(reference["losses"]) \
            or not all(math.isfinite(v) for v in program["losses"]):
        loss_err = math.inf
    grad = leaf_gaps(program["grad"], reference["grad"], list(grads))
    change1 = leaf_gaps(program["change1"], reference["change1"], counted)
    change = leaf_gaps(program["change"], reference["change"], counted)
    tiny = sum(int((reference["grad"][n].abs() < ADAM_EPS).sum())
               for n in counted)
    first = program["losses"][:1] + [math.nan]
    loss1_err = abs(first[0] - reference["losses"][0]) \
        / max(abs(reference["losses"][0]), 1e-30)
    if not math.isfinite(loss1_err):
        loss1_err = math.inf
    return {"loss1_err": loss1_err, "loss_err": loss_err,
            "grad_err_median": float(np.median([grad[n] for n in counted])),
            "grad_err": max(grad.values()),
            "update1_err": max(change1.values()),
            "update1_err_median": float(np.median(list(change1.values()))),
            "update_err": max(change.values()),
            "update_err_median": float(np.median(list(change.values()))),
            "tiny_grad_elements": tiny,
            "leaves_left_out": len(grads) - len(counted),
            "worst_leaves": {
                "grad": sorted(grad.items(), key=lambda kv: -kv[1])[:3],
                "update": sorted(change.items(), key=lambda kv: -kv[1])[:3]},
            "program_losses": program["losses"]}


def control(cfg: dict, weights, xs, gen_state, names, device) -> dict:
    """The reference's steps in TF32, to be judged in the program's
    place."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    with tf32(True):
        return reference_steps(cfg, weights, xs, gen, names)


def reference(cfg: dict, weights, xs, gen_state, names, device) -> dict:
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    with tf32(False):
        return reference_steps(cfg, weights, xs, gen, names)


def leaf_names(spec: Spec) -> List[str]:
    """The trainable leaves: every tensor but BatchNorm's statistics."""
    return [n for n, _, _ in spec
            if not n.split(".")[-1].startswith(("running_", "num_batches"))]
