"""PyTorch port vs the JAX package in `compute_dtype: bfloat16`.

Small widths (hidden 16, 2 layers, tests/test_torch_port_train.py's
configs and batches with compute_dtype set; the GRU forms at T=8, B=16),
weights from one JAX init carried over by `compat/from_jax`, the same
seeded numpy inputs on both sides, JAX on the CPU, every dropout off (flax
Dropout patched to the identity; the port outside
`models/layers.dropout_generator`).

Tolerances. bf16 rounds at other places in the two frameworks (XLA may
skip a rounding inside a fused step; the port's recurrence rounds only
the carried h), so each side sits about one bf16 rounding chain from the
exact value. A probe of JAX `gru_layer(dtype=bf16)` against a per-op
torch bf16 loop (T=20, B=8, H=32) measured max |d| 9.6e-3 of max |y|, the
size of JAX's own bf16-vs-fp32 distance (9.9e-3). So:
  - forwards and losses: within FWD_TOL = 2^-6 of the tensor's largest
    magnitude (a loss: of itself);
  - gradients: each test takes JAX's fp32 gradient g32 from the same
    weights as the exact one and holds the port's bf16 error to JAX's,
    tensor by tensor: ||g_port - g32|| <= c ||g_jax - g32|| + 2^-6
    ||g32||. Tensors whose gradient a batch-statistics BatchNorm or a
    softmax cancels (exactly zero in exact arithmetic) are measured
    against the tree's largest norm instead of their own. The GRU forms
    take c = 1: the port's bf16 GRU gradient is no farther from fp32 than
    JAX's (scripts/bf16_grad_readings.py over 8 input seeds of each form:
    the port's error at most 2^-6 of the norm, JAX's 0.6 to 2.4 %). The
    train steps of b_rvq, d_tcn, d_tf, the feedback step and the audio
    Part d take c = 2 (over 8 batch seeds each needed at most 1.89). The
    steps of b_gssoft, b_tf_gssoft and d_gru keep c = 4, which holds at
    the committed inputs only: over 8 batch seeds they need up to 13.4,
    9.6 and 60 (Part d with the GRU encoder: the port's decoder
    pre_linear gradient 55 % from fp32, JAX's 0.9 %). XLA on the CPU
    rounds bf16 at other places than the port:
    a dot's fp32 result feeds a BatchNorm unrounded, the residuals a
    backward scan reads are stored in bf16, a scan's weight gradients
    accumulate in bf16; and at these widths (batch 8) a step's bf16
    gradient moves by up to ~1/3 of the largest gradient norm with where
    it rounds, in JAX as in the port. PERF.md section 7 keeps the
    readings.
Every test also shows that bf16 ran: the port's bf16 result differs from
its fp32 result (same weights, same inputs) by more than BF16_RAN = 1e-3
of the largest magnitude, and the dtypes at JAX's cast sites agree:
outputs, logits, the quantizer's input and encodings fp32, parameters and
gradients fp32, the GRU's outputs bf16. Tokens are compared exactly from
the same fp32 hidden; end to end a token may flip only where the JAX
quantizer's own margin between the two codes is within FWD_TOL of its
largest distance.

Here: the GRU forms (layer, reverse, masked both ways, cell) and one
train step of Part b (GS-Soft and residual VQ over the BiGRU, GS-Soft over
the transformer encoder) and Part d (TCN, GRU, transformer).
tests/test_torch_port_train_bf16_more.py holds the rest, with the same
tolerances: the feedback step, the audio Part d, the eval decode and the
tokens, the bf16 checkpoint.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture2vec_tpu.models import gru as jgru
from gesture2vec_tpu.train.config import load_config as jax_load_config
from gesture2vec_tpu_torch.compat.from_jax import jax_tree, param_entries
from gesture2vec_tpu_torch.models import gru as pgru
from gesture2vec_tpu_torch.train.config import load_config
from gesture2vec_tpu_torch.train.optim import Adam
# the one-step harness and its autouse one-thread fixture
from tests.test_torch_port_train import (  # noqa: F401
    CANCELLED, PARTS, _batches, _grab, _jax_setup, _leaves, _loss_of,
    _make_step, _np, _port_setup, _torch_batch, no_jax_dropout,
    torch_one_thread)

FWD_TOL, BF16_RAN = 2.0 ** -6, 1e-3
BF16 = {"compute_dtype": "bfloat16"}


def _max_rel(got, want):
    """max |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _f32(x):
    """A torch or JAX array as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _host(state):
    """A host copy of a JAX train state (the JAX steps donate theirs)."""
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), state)


def _grad_tree(model):
    entries = param_entries(model)
    for _, p, _, _ in entries:
        assert p.dtype == torch.float32
        assert p.grad is None or p.grad.dtype == torch.float32
    return jax_tree(entries, {id(p): (p.grad if p.grad is not None
                                      else torch.zeros_like(p))
                              for _, p, _, _ in entries})


def _cancelled(path):
    return path in CANCELLED or path[-2:] == ("k", "bias")


def _grads_close(got, want, want32, what, cancelled=_cancelled, factor=4):
    """Each tensor's bf16 gradient `got` no farther from JAX's fp32 one
    (want32) than `factor` times JAX's bf16 one (want) is, plus FWD_TOL of
    its norm (cancelled ones: both measured against the tree's largest
    norm)."""
    g, w, w32 = (dict(_leaves(t)) for t in (got, want, want32))
    assert sorted(g) == sorted(w) == sorted(w32), what
    top = max(float(np.linalg.norm(v)) for v in w32.values())
    for path, exact in w32.items():
        scale = top if cancelled(path) else float(np.linalg.norm(exact))
        if scale == 0.0:
            assert not np.any(g[path]) and not np.any(w[path]), what
            continue
        err = float(np.linalg.norm(g[path] - exact)) / scale
        jax_err = float(np.linalg.norm(w[path] - exact)) / scale
        assert err <= factor * jax_err + FWD_TOL, \
            f"{what} {'/'.join(path)}: {err} (JAX bf16's: {jax_err})"


def _trees_differ(a, b):
    """The largest per-tensor max |a - b| / max |b| of two trees."""
    x, y = dict(_leaves(a)), dict(_leaves(b))
    return max(_max_rel(x[k], y[k]) for k in y
               if np.abs(y[k]).max() > 0)


# -- the GRU forms --------------------------------------------------------
T, B, IN, H = 8, 16, 12, 16
FORMS = ("layer", "layer_reverse", "masked", "masked_reverse", "cell")


def _gru_inputs(seed):
    rng = np.random.default_rng(seed)
    s = H ** -0.5
    return {"xs": rng.normal(size=(T, B, IN)).astype(np.float32),
            "h0": (0.5 * rng.normal(size=(B, H))).astype(np.float32),
            "w_ih": rng.uniform(-s, s, (3 * H, IN)).astype(np.float32),
            "w_hh": rng.uniform(-s, s, (3 * H, H)).astype(np.float32),
            "b_ih": rng.uniform(-s, s, 3 * H).astype(np.float32),
            "b_hh": rng.uniform(-s, s, 3 * H).astype(np.float32),
            "lengths": rng.integers(1, T + 1, B).astype(np.int32),
            "dys": rng.normal(size=(T, B, H)).astype(np.float32),
            "dh": rng.normal(size=(B, H)).astype(np.float32)}


def _jax_gru(form, a, dtype):
    w = [jnp.asarray(a[k]) for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    xs, h0 = jnp.asarray(a["xs"]), jnp.asarray(a["h0"])
    if form == "cell":
        return jgru.gru_cell(xs[0], h0, *w, dtype=dtype), None
    if form.startswith("masked"):
        return jgru.masked_gru_layer(xs, jnp.asarray(a["lengths"]), h0, *w,
                                     reverse=form.endswith("reverse"),
                                     dtype=dtype)
    return jgru.gru_layer(xs, h0, *w, reverse=form.endswith("reverse"),
                          dtype=dtype)


def _port_gru(form, t, dtype):
    w = [t[k] for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    if form == "cell":
        return pgru.gru_cell(t["xs"][0], t["h0"], *w, dtype=dtype), None
    if form.startswith("masked"):
        return pgru.masked_gru_layer(t["xs"], t["lengths"], t["h0"], *w,
                                     reverse=form.endswith("reverse"),
                                     dtype=dtype)
    return pgru.gru_layer(t["xs"], t["h0"], *w,
                          reverse=form.endswith("reverse"), dtype=dtype)


@pytest.mark.parametrize("form", FORMS)
def test_gru_forms_match_jax(form):
    """Each GRU form in bf16 against JAX's with dtype=bfloat16: outputs and
    last hidden within FWD_TOL, both bf16; for the sequence layers the
    gradient of every input and weight against JAX's (through the bf16
    gate-saving forward and the bf16 backward's plain versions)."""
    a = _gru_inputs(3)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t["lengths"] = t["lengths"].long()
    jy, jh = _jax_gru(form, a, jnp.bfloat16)
    py, ph = _port_gru(form, t, torch.bfloat16)
    assert py.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    assert _max_rel(_f32(py), _f32(jy)) <= FWD_TOL
    if jh is not None:
        assert ph.dtype == torch.bfloat16 and jh.dtype == jnp.bfloat16
        assert _max_rel(_f32(ph), _f32(jh)) <= FWD_TOL
    # bf16 ran: the port's fp32 form is another result
    py32, _ = _port_gru(form, t, None)
    assert py32.dtype == torch.float32
    assert _max_rel(_f32(py), _f32(py32)) > BF16_RAN
    if form == "cell":
        return
    names = ("xs", "h0", "w_ih", "w_hh", "b_ih", "b_hh")

    def jgrads(dtype):
        def jloss(*args):
            d = dict(a, **dict(zip(names, args)))
            ys, h = _jax_gru(form, d, dtype)
            return jnp.sum(ys.astype(jnp.float32) * a["dys"]) \
                + jnp.sum(h.astype(jnp.float32) * a["dh"])
        g = jax.grad(jloss, argnums=tuple(range(6)))(
            *(jnp.asarray(a[k]) for k in names))
        return {k: _f32(x) for k, x in zip(names, g)}
    leaves = {k: t[k].clone().requires_grad_() for k in names}
    ys, h = _port_gru(form, dict(t, **leaves), torch.bfloat16)
    (torch.sum(ys.float() * t["dys"]) + torch.sum(h.float() * t["dh"])
     ).backward()
    got = {k: leaves[k].grad.numpy() for k in names}
    assert all(leaves[k].grad.dtype == torch.float32 for k in names)
    _grads_close(got, jgrads(jnp.bfloat16), jgrads(None), form, factor=1)


# -- one train step per part ------------------------------------------------
STEP_PARTS = ("b_gssoft", "b_rvq", "b_tf_gssoft", "d_tcn", "d_gru", "d_tf")
# the gradient factor c of each step (see the module note): 2 where it
# held over 8 batch seeds (scripts/bf16_grad_readings.py: at most 1.89),
# 4 for the three steps where it does not
STEP_FACTOR = {"b_gssoft": 4, "b_rvq": 2, "b_tf_gssoft": 4, "d_tcn": 2,
               "d_gru": 4, "d_tf": 2}


@pytest.mark.parametrize("part", STEP_PARTS)
def test_train_step_matches_jax(part, no_jax_dropout):
    """One bf16 train step from the same JAX-initialised weights and batch
    as JAX's bf16 make_train_step: the loss within FWD_TOL, every gradient
    against JAX's (see the module note); parameters and gradients fp32;
    the fp32 step's gradients differ (bf16 ran)."""
    raw = {**PARTS[part], **BF16}
    cfg, jcfg = load_config(raw), jax_load_config(raw)
    batch = _batches(part, raw, 7, 1)[0]

    def jax_step(c):
        _, st, jstep = _jax_setup(part, c, _grab())
        host = _host(st)
        new, metrics = jstep(st, batch, jax.random.PRNGKey(1))
        return host, _np(new.opt_state["g"]), metrics

    state, jgrads, metrics = jax_step(jcfg)
    _, jgrads32, _ = jax_step(jax_load_config(PARTS[part]))

    def port_step(c):
        model, cls = _port_setup(part, c, state)
        step = _make_step(part, cls, c, model, Adam(model.parameters(),
                                                    1e-3))
        loss = _loss_of(step.loss(*_torch_batch(part, batch)))
        loss.backward()
        return model, loss, _grad_tree(model)

    model, loss, grads = port_step(cfg)
    assert model.compute_dtype == torch.bfloat16
    assert loss.dtype == torch.float32
    if part.startswith("d"):
        # the logits, JAX's fp32 island (CE and the argmax feedback)
        kw = {"stage_targets": _torch_batch(part, batch)[3]} \
            if model.stage_conditional else {}
        with torch.no_grad():
            res = model(*_torch_batch(part, batch)[:3], **kw)
        assert res["logits"].dtype == torch.float32
    assert abs(float(loss) - float(metrics["loss"])) \
        <= FWD_TOL * abs(float(metrics["loss"]))
    _grads_close(grads, jgrads, jgrads32, "grad", factor=STEP_FACTOR[part])
    _, _, grads32 = port_step(load_config(PARTS[part]))
    assert _trees_differ(grads, grads32) > BF16_RAN
