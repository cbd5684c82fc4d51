"""PyTorch port vs the JAX package: GPipe pipeline parallelism over "pp".

The port's counterparts of tests/test_pipeline_parallel.py: the forward
against the sequential stage composition and JAX's gpipe, the stacked
parameters' gradients through the explicit backward schedule against
the sequential stack's and JAX's, the composition with a dp axis, the
indivisible batch, and the pipelined GRU stack (one `models/gru.
gru_layer` a stage). The port's pp ranks are 4 gloo processes on the CPU
(`parallel/launch`), every pipeline run of this file in one launch; the
JAX side runs on its 8 virtual devices. dp=2 x pp=4 becomes dp=2 x pp=2
(4 ranks at most). Tolerances are the JAX tests': 1e-6 on the forward
and the gradients.
"""
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.parallel import launch
from gesture2vec_tpu_torch.parallel.mesh import make_mesh
from gesture2vec_tpu_torch.parallel.pipeline import (dense_stage, gpipe,
                                                     gru_stage, run_stack,
                                                     stack_stages)

H, B, S, M, T = 16, 8, 4, 4, 6   # width, batch, stages, microbatches, steps
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _dense(seed=0):
    rng = np.random.default_rng(seed)
    stacked = stack_stages([{"w": _t(rng.normal(size=(H, H), scale=0.3)),
                             "b": _t(rng.normal(size=(H,), scale=0.1))}
                            for _ in range(S)])
    return (stacked, _t(rng.normal(size=(B, H))),
            _t(rng.normal(size=(B, H))))


def _gru(seed=1):
    rng = np.random.default_rng(seed)
    layers = [{"w_ih": _t(rng.normal(size=(3 * H, H), scale=0.2)),
               "w_hh": _t(rng.normal(size=(3 * H, H), scale=0.2)),
               "b_ih": _t(rng.normal(size=(3 * H,), scale=0.05)),
               "b_hh": _t(rng.normal(size=(3 * H,), scale=0.05))}
              for _ in range(S)]
    return (stack_stages(layers), _t(rng.normal(size=(B, T, H))),
            _t(rng.normal(size=(B, T, H))))


def _stages(stacked, n):
    return {k: v[:n] for k, v in stacked.items()}


def _sequential(stage, stacked, x, target):
    """The plain composition's output and the gradients of the test loss
    with respect to the stacked parameters and the input."""
    st = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    xx = x.clone().requires_grad_()
    y = xx
    for i in range(next(iter(st.values())).shape[0]):
        y = stage({k: v[i] for k, v in st.items()}, y)
    torch.mean((y - target) ** 2).backward()
    return y.detach(), {k: v.grad for k, v in st.items()}, xx.grad


@pytest.fixture(scope="module")
def piped():
    """Rank 0's run_stack results: dense over pp=4, dense over dp=2 x
    pp=2, the GRU stack over pp=4."""
    dense, gru = _dense(), _gru()
    calls = [(run_stack, ("dense", dense[0], dense[1], dense[2],
                          {"pp": S}, M), {}),
             (run_stack, ("dense", _stages(dense[0], 2), dense[1],
                          dense[2], {"dp": 2, "pp": 2}, M), {}),
             (run_stack, ("gru", gru[0], gru[1], gru[2], {"pp": S}, M), {})]
    out = launch.run(launch.call_all, (calls,), world_size=4, device="cpu")
    return dict(zip(("dense", "dense_dp", "gru"), out))


def _jax(stacked):
    import jax.numpy as jnp
    return {k: jnp.asarray(v.numpy()) for k, v in stacked.items()}


def test_gpipe_matches_sequential(piped):
    """pp=4: the output equals the sequential composition and JAX's
    gpipe."""
    import jax.numpy as jnp

    from gesture2vec_tpu.parallel.mesh import make_mesh as jmesh
    from gesture2vec_tpu.parallel.pipeline import gpipe as jgpipe

    stacked, x, target = _dense()
    y, _, _ = _sequential(dense_stage, stacked, x, target)
    got = piped["dense"]["y"]
    np.testing.assert_allclose(got.numpy(), y.numpy(), rtol=TOL, atol=TOL)
    want = jgpipe(lambda p, v: jnp.tanh(v @ p["w"] + p["b"]),
                  _jax(stacked), jnp.asarray(x.numpy()),
                  mesh=jmesh({"pp": S}), n_micro=M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_gpipe_gradients_match_sequential(piped):
    """The explicit backward schedule gives the sequential stack's
    gradients (every stage's parameters and the input), and JAX's
    jax.grad through its schedule."""
    import jax
    import jax.numpy as jnp

    from gesture2vec_tpu.parallel.mesh import make_mesh as jmesh
    from gesture2vec_tpu.parallel.pipeline import gpipe_fn as jgpipe_fn

    stacked, x, target = _dense()
    _, grads, x_grad = _sequential(dense_stage, stacked, x, target)
    got = piped["dense"]
    for k in grads:
        np.testing.assert_allclose(got["grads"][k].numpy(),
                                   grads[k].numpy(), rtol=1e-5, atol=TOL)
    np.testing.assert_allclose(got["x_grad"].numpy(), x_grad.numpy(),
                               rtol=1e-5, atol=TOL)
    f = jgpipe_fn(lambda p, v: jnp.tanh(v @ p["w"] + p["b"]),
                  jmesh({"pp": S}), n_micro=M)
    jx, jt = jnp.asarray(x.numpy()), jnp.asarray(target.numpy())
    want = jax.grad(lambda sp: jnp.mean((f(sp, jx) - jt) ** 2))(
        _jax(stacked))
    for k in grads:
        np.testing.assert_allclose(got["grads"][k].numpy(),
                                   np.asarray(want[k]), rtol=1e-5, atol=TOL)


def test_gpipe_composes_with_dp(piped):
    """dp=2 x pp=2: the microbatches' rows split over dp; the output and
    the gradients are the sequential two-stage stack's."""
    stacked, x, target = _dense()
    y, grads, x_grad = _sequential(dense_stage, _stages(stacked, 2), x,
                                   target)
    got = piped["dense_dp"]
    np.testing.assert_allclose(got["y"].numpy(), y.numpy(), rtol=TOL,
                               atol=TOL)
    for k in grads:
        np.testing.assert_allclose(got["grads"][k].numpy(),
                                   grads[k].numpy(), rtol=1e-5, atol=TOL)
    np.testing.assert_allclose(got["x_grad"].numpy(), x_grad.numpy(),
                               rtol=1e-5, atol=TOL)


def test_gpipe_rejects_indivisible_batch():
    """A batch n_micro does not divide raises ValueError (a plain
    process's mesh: no rank starts)."""
    stacked, _, _ = _dense()
    with pytest.raises(ValueError, match="n_micro"):
        gpipe(dense_stage, stacked, torch.zeros(B + 1, H),
              mesh=make_mesh({"pp": S}, "cpu"), n_micro=M)


def test_pipelined_gru_stack_matches_sequential(piped):
    """One GRU layer a stage (zero initial hidden) over pp=4: the
    sequential deep stack's output and gradients, and JAX's
    pipelined_gru_stack's output."""
    from gesture2vec_tpu.parallel.mesh import make_mesh as jmesh
    from gesture2vec_tpu.parallel.pipeline import \
        pipelined_gru_stack as jstack
    import jax.numpy as jnp

    stacked, x, target = _gru()
    y, grads, _ = _sequential(gru_stage, stacked, x, target)
    got = piped["gru"]
    np.testing.assert_allclose(got["y"].numpy(), y.numpy(), rtol=1e-5,
                               atol=TOL)
    for k in grads:
        np.testing.assert_allclose(got["grads"][k].numpy(),
                                   grads[k].numpy(), rtol=1e-5, atol=TOL)
    want = jstack(jnp.asarray(x.numpy()), _jax(stacked),
                  mesh=jmesh({"pp": S}), n_micro=M)
    np.testing.assert_allclose(got["y"].numpy(), np.asarray(want),
                               rtol=1e-5, atol=TOL)
