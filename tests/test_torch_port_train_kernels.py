"""PyTorch port vs the JAX package: the gradient of the GRU sequence.

`ops/gru_kernel.gru_sequence_backward_plain` (the backward kernel's
plain version, which reads the gates that `gru_sequence_gates_plain`
saved), the recompute-based `gru_sequence_backward_recompute` and
`GRUSequenceFn` (the saved-gate path) against `jax.vjp` of the JAX
package's `gru_layer` and `masked_gru_layer`, forward and reverse, on
the same numpy inputs and output gradients: every gradient within 1e-5
of the JAX gradient's largest magnitude (fp32 sums in another order over
a few steps). The saved-gate backward equals the recompute-based one
within 1e-6, and the saved gates equal the gates recomputed from the
outputs. `torch.autograd.gradcheck` holds the Function's plain backward
(the saved-gate path) against finite differences in float64. The
`gpu`-marked test holds, on the card, the forward's training variant
against the inference launch (outputs bitwise) and its gates against the
recomputed ones (1e-6), and the Function's gradients against autograd
through the plain forward, within 1e-4 of each tensor's largest
magnitude; a second one checks that the Part-b eval decode raises there
for a decoder the chunk-decoder kernel cannot run, and a third holds one
train step of the transformer models (the recipe's Part d, its feedback
step, the `seq_arch: transformer` tokenizer) on the card against the
CPU, and a fourth one step of the Part-a VQ frame model with VAE heads
and of the similarity-supervised Part-b step (its pair forwards at B=3),
a fifth the four bf16 instantiations against their bf16 plain
versions, and a sixth one `compute_dtype: bfloat16` train step of Part b
(GS-Soft and residual VQ over the BiGRU, residual VQ over the
transformer) and of Part d (TCN, GRU, the recipe's transformer and its
feedback step) on the card against the CPU's bf16 step, over three
seeds. The CPU tests also hold the bf16 launch mirrors' limits and
that a bf16 call never takes an fp32 path. The JAX package's
GRU module (it imports flax) is imported inside the CPU tests, so the
file also collects on a machine with the card and without flax.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.models import gru as pgru
from gesture2vec_tpu_torch.ops import gru_kernel as gk

TOL = 1e-5
T, B, IN, H = 7, 5, 6, 16


def _inputs(seed):
    rng = np.random.default_rng(seed)
    b = 1.0 / np.sqrt(H)
    f = np.float32
    return {"xs": rng.normal(size=(T, B, IN)).astype(f),
            "h0": (0.5 * rng.normal(size=(B, H))).astype(f),
            "w_ih": rng.uniform(-b, b, (3 * H, IN)).astype(f),
            "w_hh": rng.uniform(-b, b, (3 * H, H)).astype(f),
            "b_ih": rng.uniform(-b, b, (3 * H,)).astype(f),
            "b_hh": rng.uniform(-b, b, (3 * H,)).astype(f),
            "dys": rng.normal(size=(T, B, H)).astype(f),
            "dh": rng.normal(size=(B, H)).astype(f),
            "lengths": np.array([7, 3, 1, 0, 5], np.int32)}


def _close(got, want, name):
    got = np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{name}: {err} of the largest magnitude"


NAMES = ("xs", "h0", "w_ih", "w_hh", "b_ih", "b_hh")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_gradients_match_jax_vjp(reverse, masked):
    """All six gradients of a GRU layer (through the Function's plain
    backward and autograd of the input projection) against jax.vjp."""
    from gesture2vec_tpu.models import gru as jgru
    d = _inputs(3 + 2 * reverse + masked)
    args = [d[n] for n in NAMES]
    if masked:
        def jfn(xs, h0, w_ih, w_hh, b_ih, b_hh):
            return jgru.masked_gru_layer(xs, jnp.asarray(d["lengths"]), h0,
                                         w_ih, w_hh, b_ih, b_hh, reverse)
    else:
        def jfn(xs, h0, w_ih, w_hh, b_ih, b_hh):
            return jgru.gru_layer(xs, h0, w_ih, w_hh, b_ih, b_hh, reverse)
    (ys_j, h_j), vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(d["dys"]), jnp.asarray(d["dh"])))

    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    if masked:
        ys, h = pgru.masked_gru_layer(
            leaves[0], torch.from_numpy(d["lengths"]), *leaves[1:], reverse)
    else:
        ys, h = pgru.gru_layer(*leaves, reverse)
    _close(ys.detach(), ys_j, "ys")
    _close(h.detach(), h_j, "h_last")
    got = torch.autograd.grad((ys, h), leaves, (torch.from_numpy(d["dys"]),
                                                torch.from_numpy(d["dh"])))
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name)


@pytest.mark.parametrize("saved", ["recompute", "gates"])
@pytest.mark.parametrize("reverse", [False, True])
def test_backward_plain_matches_jax_recurrence_vjp(reverse, saved):
    """The plain backward's d x_proj and d h0 against jax.vjp of the JAX
    recurrence over x_proj, and its dgh through dW_hh, db_hh: from the
    gates the plain forward saved (the kernel's plain version) and from
    x_proj, recomputing them (the oracle)."""
    from gesture2vec_tpu.models import gru as jgru
    d = _inputs(11 + reverse)
    xp = np.einsum("tbi,gi->tbg", d["xs"], d["w_ih"]) + d["b_ih"]
    xp = xp.astype(np.float32)
    eye_in = np.eye(3 * H, dtype=np.float32)

    def jfn(xp_, h0, w_hh, b_hh):
        # x_proj through an identity input projection
        return jgru.gru_layer(xp_, h0, eye_in, w_hh,
                              jnp.zeros(3 * H), b_hh, reverse)
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, (xp, d["h0"], d["w_hh"],
                                             d["b_hh"])))
    want = vjp((jnp.asarray(d["dys"]), jnp.asarray(d["dh"])))
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    xp_t = torch.from_numpy(xp)
    ys, _, gates = gk.gru_sequence_gates_plain(xp_t, t["h0"], t["w_hh"],
                                               t["b_hh"], reverse)
    if saved == "gates":
        dxp, dgh, dh0 = gk.gru_sequence_backward_plain(
            gates, t["h0"], t["w_hh"], ys, t["dys"], t["dh"], reverse)
    else:
        dxp, dgh, dh0 = gk.gru_sequence_backward_recompute(
            xp_t, t["h0"], t["w_hh"], t["b_hh"], ys, t["dys"], t["dh"],
            reverse)
    prev = gk.h_prev_stack(ys, t["h0"], reverse)
    dw = dgh.reshape(-1, 3 * H).t() @ prev.reshape(-1, H)
    for name, g, w in (("dx_proj", dxp, want[0]), ("dh0", dh0, want[1]),
                       ("dw_hh", dw, want[2]),
                       ("db_hh", dgh.sum((0, 1)), want[3])):
        _close(g, w, name)
    # dgh differs from d x_proj only in the n gate
    np.testing.assert_array_equal(dgh[..., :2 * H].numpy(),
                                  dxp[..., :2 * H].numpy())


def _torch_inputs(seed):
    d = _inputs(seed)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    xp = np.einsum("tbi,gi->tbg", d["xs"], d["w_ih"]) + d["b_ih"]
    return torch.from_numpy(xp.astype(np.float32)), t


@pytest.mark.parametrize("reverse", [False, True])
def test_backward_plain_matches_recompute(reverse):
    """The saved-gate plain backward equals the recompute-based one within
    1e-6 of each tensor's largest magnitude."""
    xp, t = _torch_inputs(21 + reverse)
    ys, _, gates = gk.gru_sequence_gates_plain(xp, t["h0"], t["w_hh"],
                                               t["b_hh"], reverse)
    got = gk.gru_sequence_backward_plain(gates, t["h0"], t["w_hh"], ys,
                                         t["dys"], t["dh"], reverse)
    want = gk.gru_sequence_backward_recompute(xp, t["h0"], t["w_hh"],
                                              t["b_hh"], ys, t["dys"],
                                              t["dh"], reverse)
    for name, a, b in zip(("dx_proj", "dgh", "dh0"), got, want):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 1e-6, f"{name}: {err}"


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_gates_match_gates_from_ys(reverse):
    """The gates the plain forward returns equal the gates recomputed from
    its outputs (one product over all steps), and its outputs are those of
    gru_sequence_plain, bitwise."""
    xp, t = _torch_inputs(31 + reverse)
    args = (xp, t["h0"], t["w_hh"], t["b_hh"], reverse)
    ys, h, gates = gk.gru_sequence_gates_plain(*args)
    ys_i, h_i = gk.gru_sequence_plain(*args)
    assert torch.equal(ys, ys_i) and torch.equal(h, h_i)
    assert gates.shape == (T, B, 4 * H)
    want = gk.gates_from_ys(*args[:4], ys, reverse)
    err = float((gates - want).abs().max() / want.abs().max())
    assert err <= 1e-6, err


@pytest.mark.parametrize("reverse", [False, True])
def test_function_gradcheck_float64(reverse):
    """The Function's plain forward and backward, the saved-gate path,
    against finite differences (float64 on the CPU)."""
    g = torch.Generator().manual_seed(5 + reverse)
    Tn, Bn, Hn = 4, 3, 5
    args = [torch.randn(s, generator=g, dtype=torch.float64,
                        requires_grad=True)
            for s in ((Tn, Bn, 3 * Hn), (Bn, Hn), (3 * Hn, Hn), (3 * Hn,))]
    ys, _ = gk.GRUSequenceFn.apply(*args, reverse)
    # the Function saved the gates (T, B, 4H), not x_proj
    assert ys.grad_fn.saved_tensors[0].shape == (Tn, Bn, 4 * Hn)
    assert torch.autograd.gradcheck(
        lambda *a: gk.GRUSequenceFn.apply(*a, reverse), args)


def test_gru_sequence_takes_the_function_only_with_grad():
    """With grad enabled and a leaf that requires it, gru_sequence's
    outputs carry the Function's backward; under no_grad they do not."""
    d = _inputs(2)
    xp = torch.randn(T, B, 3 * H)
    w = torch.from_numpy(d["w_hh"]).requires_grad_()
    ys, _ = gk.gru_sequence(xp, torch.from_numpy(d["h0"]), w,
                            torch.from_numpy(d["b_hh"]))
    assert type(ys.grad_fn).__name__ == "GRUSequenceFnBackward"
    with torch.no_grad():
        ys, _ = gk.gru_sequence(xp, torch.from_numpy(d["h0"]), w,
                                torch.from_numpy(d["b_hh"]))
    assert ys.grad_fn is None


def test_backward_launch_shape_limit():
    """The backward kernel's shared memory mirror: H=200 fits (164,000
    bytes a block), H=244 fits, H=245 does not; the forward's limit,
    H=232, is the tighter one."""
    assert gk.backward_launch_shape(128, 200)["smem_bytes"] == 164000
    assert gk.backward_launch_shape(117, 216)["clusters"] == 6
    assert gk.backward_launch_shape(1, 244)["threads"] == 320
    with pytest.raises(ValueError, match="GRU backward"):
        gk.backward_launch_shape(128, 245)
    gk.launch_shape(128, 232)
    with pytest.raises(ValueError):
        gk.launch_shape(128, 233)


def test_bf16_launch_shape_limits():
    """The bf16 instantiations' limits in the mirrors (a bf16 weight slice
    is half the bytes): the GRU forward takes H <= 340 (fp32 232), its
    backward H <= 256 (its 320 threads; fp32 244, its shared memory), the
    chunk decoder H <= 256 at D=40 (a warp a unit; fp32 204)."""
    bf16 = torch.bfloat16
    for fn, last in ((gk.launch_shape, 340),
                     (gk.backward_launch_shape, 256)):
        fn(128, last, dtype=bf16)
        with pytest.raises(ValueError, match="bfloat16"):
            fn(128, last + 1, dtype=bf16)
    assert gk.launch_shape(128, 200, dtype=bf16)["smem_bytes"] == 94440
    assert gk.backward_launch_shape(128, 200, dtype=bf16)["smem_bytes"] \
        == 104000
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    assert dk.launch_shape(128, 200, 40, dtype=bf16)["smem_bytes"] == 131104
    dk.launch_shape(1, 256, 40, dtype=bf16)
    for H, dt in ((257, bf16), (205, torch.float32)):
        with pytest.raises(ValueError):
            dk.launch_shape(1, H, 40, dtype=dt)


def test_bf16_takes_no_fp32_path():
    """A bf16 call stays bf16: mixed storage types are refused (nothing is
    upcast into the fp32 kernel), the plain versions return bf16, and the
    carried h is bf16-exact at every step."""
    rng = np.random.default_rng(1)
    bf = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32) * sc
                              ).bfloat16()
          for k, s, sc in (("h0", (7, 16), 0.5), ("w_hh", (48, 16), 0.25),
                           ("b_hh", (48,), 0.25))}
    xp = torch.from_numpy(rng.normal(size=(5, 7, 48)).astype(np.float32)
                          ).bfloat16()
    with pytest.raises(ValueError, match="dtype"):
        gk.gru_sequence(xp, bf["h0"], bf["w_hh"].float(), bf["b_hh"])
    ys, h, gates = gk.gru_sequence_gates(xp, bf["h0"], bf["w_hh"],
                                         bf["b_hh"])
    assert ys.dtype == h.dtype == gates.dtype == torch.bfloat16
    # each step from the bf16 carry equals one fp32 step rounded to bf16
    prev = gk.h_prev_stack(ys, bf["h0"], False).float()
    step, _ = gk._step(xp.float().reshape(-1, 48), prev.reshape(-1, 16),
                       bf["w_hh"].float(), bf["b_hh"].float())
    assert torch.equal(step.bfloat16().reshape(ys.shape), ys)
    grads = gk.gru_sequence_backward(gates, bf["h0"], bf["w_hh"], ys,
                                     torch.ones_like(ys), h, False)
    assert all(g.dtype == torch.bfloat16 for g in grads)


@pytest.mark.gpu
def test_bf16_kernels_on_card_match_plain():
    """On the card: each bf16 instantiation (GRU sequence, its gate-saving
    variant, the GRU backward, the chunk decoder) against its bf16 plain
    version at the main path's shapes, within 2^-6 of the largest
    magnitude (fp32 sums in another order; a bf16 rounding of the carry
    may then flip, and the recurrence carries it); the bf16 counters move
    and the fp32 ones do not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    g = torch.Generator(device="cuda").manual_seed(0)
    bf16, tol = torch.bfloat16, 2.0 ** -6

    def rnd(*s, sc=1.0):
        return (torch.randn(s, device="cuda", generator=g) * sc).to(bf16)

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    before = (gk.gru_sequence.launches, gk.gru_sequence_backward.launches,
              dk.fused_chunk_decode.launches)
    n_bf16 = gk.gru_sequence.launches_bf16
    H = 200
    for T, B in ((20, 128), (48, 64), (6, 128)):
        for reverse in (False, True):
            args = (rnd(T, B, 3 * H), rnd(B, H, sc=0.5),
                    rnd(3 * H, H, sc=H ** -0.5), rnd(3 * H, sc=0.1))
            ys, h = gk.gru_sequence(*args, reverse)
            ys_g, h_g, gates = gk.gru_sequence_gates(*args, reverse)
            yp, hp, gp = gk.gru_sequence_gates_plain(*args, reverse)
            assert torch.equal(ys, ys_g) and ys.dtype == bf16
            assert max(rel(ys, yp), rel(h, hp), rel(gates, gp)) <= tol
            dys, dh = rnd(T, B, H), rnd(B, H)
            got = gk.gru_sequence_backward(gates, args[1], args[2], ys,
                                           dys, dh, reverse)
            want = gk.gru_sequence_backward_plain(gp, args[1], args[2], yp,
                                                  dys, dh, reverse)
            assert max(rel(a, b) for a, b in zip(got, want)) <= tol
    D, n = 40, 19
    w = dk.FoldedDecoder(
        rnd(H, D, sc=D ** -0.5), rnd(H, sc=0.2).float().abs().to(bf16) + 0.5,
        rnd(H, sc=0.1), *[rnd(3 * H, H, sc=H ** -0.5),
                          rnd(3 * H, H, sc=H ** -0.5), rnd(3 * H, sc=0.1),
                          rnd(3 * H, sc=0.1)] * 2,
        rnd(D, H, sc=H ** -0.5), rnd(D, sc=0.1))
    x0, h0 = rnd(128, D), rnd(2, 128, H, sc=0.5)
    ys = dk.fused_chunk_decode(x0, h0, w, n)
    assert ys.dtype == bf16
    assert rel(ys, dk.fused_chunk_decode_plain(x0, h0, w, n)) <= tol
    torch.cuda.synchronize()
    assert gk.gru_sequence.launches_bf16 == n_bf16 + 12
    assert (gk.gru_sequence.launches, gk.gru_sequence_backward.launches,
            dk.fused_chunk_decode.launches) == before


@pytest.mark.gpu
def test_backward_kernel_on_card_matches_autograd_of_plain():
    """On the card: the forward's training variant gives outputs bitwise
    equal to the inference launch's and gates within 1e-6 of the gates
    recomputed from those outputs; the Function's gradients (variant and
    backward kernel) match autograd through the plain forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    Hc = 200
    for Tc, Bc in ((20, 128), (48, 37)):
        for reverse in (False, True):
            leaves = [torch.randn(s, device="cuda", generator=g) * sc
                      for s, sc in (((Tc, Bc, 3 * Hc), 1.0), ((Bc, Hc), 0.5),
                                    ((3 * Hc, Hc), Hc ** -0.5),
                                    ((3 * Hc,), Hc ** -0.5))]
            ys_i, h_i = gk.gru_sequence(*leaves, reverse)
            ys_g, h_g, gates = gk.gru_sequence_gates(*leaves, reverse)
            assert torch.equal(ys_g, ys_i) and torch.equal(h_g, h_i)
            want = gk.gates_from_ys(*leaves, ys_g, reverse)
            err = (gates - want).abs().max() / want.abs().max()
            assert err.item() <= 1e-6
            leaves = [t.requires_grad_() for t in leaves]
            dys = torch.randn(Tc, Bc, Hc, device="cuda", generator=g)
            dh = torch.randn(Bc, Hc, device="cuda", generator=g)
            ys, h = gk.GRUSequenceFn.apply(*leaves, reverse)
            got = torch.autograd.grad((ys, h), leaves, (dys, dh))
            ys_p, h_p = gk.gru_sequence_plain(*leaves, reverse)
            want = torch.autograd.grad((ys_p, h_p), leaves, (dys, dh))
            for a, b in zip(got, want):
                err = (a - b).abs().max() / b.abs().max()
                assert err.item() <= 1e-4


@pytest.mark.gpu
def test_ineligible_eval_decode_raises_on_card():
    """On the card the Part-b eval decode runs the chunk-decoder kernel or
    raises: it never takes the plain loop unasked."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gesture2vec_tpu_torch.models.seq_ae import SeqDecoder

    dec = SeqDecoder(8, H, 2, 6, 16, n_pre_poses=2).cuda().eval()
    with pytest.raises(ValueError, match="one seed frame"):
        dec.decode(torch.zeros(2, 4, H, device="cuda"),
                   torch.zeros(4, 6, 8, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("run", ["d_tf_recipe", "d_tf_recipe_feedback",
                                 "b_tf_rvq"])
def test_transformer_train_step_on_card_matches_cpu(run):
    """One train step of the transformer models on the card against the
    CPU from the same weights and batch, dropout off: the recipe's Part d
    (4 chained stages, label smoothing), its feedback-matched finetune
    step, and the `seq_arch: transformer` residual-VQ tokenizer (its
    argmins through the VQ kernel): the loss and every gradient within
    1e-4 of each tensor's largest magnitude (an attention's key bias,
    whose gradient the softmax cancels, and pre_linear's bias in front of
    the batch-statistics BatchNorm, of the model's largest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy

    from gesture2vec_tpu_torch.compat.from_jax import param_entries
    from gesture2vec_tpu_torch.train import seq_ae_trainer as st
    from gesture2vec_tpu_torch.train import text2token_trainer as tt
    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.train.dae_trainer import init_model
    from gesture2vec_tpu_torch.train.optim import Adam

    rng = np.random.default_rng(3)
    bs, n_words, steps = 16, 40, 6
    if run.startswith("d"):
        cfg = load_config({
            "hidden_size": 32, "n_layers": 2, "autoencoder_vq_components": 16,
            "n_poses": 5, "sentence_frame_length": 5 * steps,
            "n_pre_poses": 1, "wordembed_dim": 12, "t2t_arch": "transformer",
            "t2t_heads": 2, "token_stages": 4, "stage_conditional": True,
            "label_smoothing": 0.1})
        cpu = tt.init_text2token(tt.make_text2token(cfg, n_words), 0,
                                 torch.device("cpu"))
        step_cls = (tt.FeedbackTrainStep if run.endswith("feedback")
                    else tt.TrainStep)
        lengths = rng.integers(3, 12, bs)
        ids = rng.integers(4, n_words, (bs, 11))
        ids[np.arange(11)[None, :] >= lengths[:, None]] = 0
        stages = rng.integers(0, 16, (bs, steps, 4))
        batch = [torch.from_numpy(a) for a in (ids, lengths, stages[:, :, 0],
                                               stages)]
    else:
        cfg = load_config({
            "hidden_size": 32, "n_layers": 2, "rep_learning_dim": 8,
            "n_poses": 10, "n_pre_poses": 1, "autoencoder_vq": True,
            "autoencoder_vq_components": 16, "autoencoder_vq_variant": "rvq",
            "rvq_stages": 4, "seq_arch": "transformer"})
        cpu = init_model(st.make_seq_ae(cfg), 0, torch.device("cpu"))
        batch = [torch.from_numpy(rng.normal(size=(bs, 10, 8)).astype(
            np.float32))]
    cpu.train()
    card = copy.deepcopy(cpu).cuda().train()
    grads, losses = [], []
    for m, dev in ((cpu, "cpu"), (card, "cuda")):
        opt = Adam(m.parameters(), 1e-3)
        step = (st.TrainStep(cfg, m, opt) if run.startswith("b")
                else step_cls(m, opt, cfg.label_smoothing))
        loss = step.loss(*(a.to(dev) for a in batch))
        loss = loss[0] if isinstance(loss, tuple) else loss
        loss.backward()
        losses.append(float(loss))
        grads.append({path: (p.grad if p.grad is not None
                             else torch.zeros_like(p)).detach().cpu()
                      for path, p, _, _ in param_entries(m)})
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
    top = max(float(g.abs().max()) for g in grads[0].values())
    for path, g in grads[0].items():
        cancelled = path[-2:] in (("k", "bias"), ("pre_linear", "bias"))
        scale = top if cancelled else max(float(g.abs().max()), 1e-30)
        err = float((grads[1][path] - g).abs().max()) / scale
        assert err <= 1e-4, f"{'/'.join(path)}: {err}"


# the card's bf16 step against the CPU's: both run the same bf16 math
# (the CPU through the kernels' bf16 plain versions), so they differ only
# where fp32 sums in another order flip a bf16 rounding. Set from a first
# run's readings of the 21 cases below (NVIDIA H100 80GB HBM3, 700.00 W):
# losses within 1.9e-7, the worst gradient 9.4e-3 of its norm
BF16_CARD_LOSS_TOL, BF16_CARD_TOL = 2.0 ** -16, 2.0 ** -5


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("run", ["b_gssoft", "b_rvq", "b_tf_rvq", "d_tcn",
                                 "d_gru", "d_tf_recipe",
                                 "d_tf_recipe_feedback"])
def test_bf16_train_steps_on_card_match_cpu(run, seed):
    """compute_dtype: bfloat16 on the card (the BiGRUs through the bf16
    GRU kernels): one train step against the CPU's bf16 step from the same
    weights (init seed) and batch (seed + 5), dropout off: the loss
    within BF16_CARD_LOSS_TOL of the CPU bf16 loss and each gradient within
    BF16_CARD_TOL of the CPU bf16 gradient's norm (the cancelled biases
    measured against the largest norm); the bf16 step launches no fp32
    GRU kernel. It prints its readings, and beside them each bf16 step's
    distance from the CPU's fp32 step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy
    import json

    from gesture2vec_tpu_torch.compat.from_jax import param_entries
    from gesture2vec_tpu_torch.train import seq_ae_trainer as st
    from gesture2vec_tpu_torch.train import text2token_trainer as tt
    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.train.dae_trainer import init_model
    from gesture2vec_tpu_torch.train.optim import Adam

    rng = np.random.default_rng(seed + 5)
    bs, n_words, steps = 16, 40, 6
    if run.startswith("d"):
        raw = {"hidden_size": 32, "n_layers": 2,
               "autoencoder_vq_components": 16, "n_poses": 5,
               "sentence_frame_length": 5 * steps, "n_pre_poses": 1,
               "wordembed_dim": 12, "autoencoder_att": True}
        if run.startswith("d_tf"):
            raw.update(t2t_arch="transformer", t2t_heads=2, token_stages=4,
                       stage_conditional=True, label_smoothing=0.1)
        else:
            raw["text_encoder"] = run[2:]
        lengths = rng.integers(3, 12, bs)
        ids = rng.integers(4, n_words, (bs, 11))
        ids[np.arange(11)[None, :] >= lengths[:, None]] = 0
        stages = rng.integers(0, 16, (bs, steps, 4))
        batch = [torch.from_numpy(a) for a in (ids, lengths,
                                               stages[:, :, 0])]
        if run.startswith("d_tf"):
            batch.append(torch.from_numpy(stages))
    else:
        raw = {"hidden_size": 32, "n_layers": 2, "rep_learning_dim": 8,
               "n_poses": 10, "n_pre_poses": 1, "autoencoder_vq": True,
               "autoencoder_vq_components": 16}
        if run != "b_gssoft":
            raw.update(autoencoder_vq_variant="rvq", rvq_stages=4)
        if run == "b_tf_rvq":
            raw["seq_arch"] = "transformer"
        batch = [torch.from_numpy(rng.normal(size=(bs, 10, 8)).astype(
            np.float32))]

    def model_of(cfg):
        if run.startswith("d"):
            return tt.init_text2token(tt.make_text2token(cfg, n_words),
                                      seed, torch.device("cpu"))
        return init_model(st.make_seq_ae(cfg), seed, torch.device("cpu"))

    def step(m, cfg, dev):
        opt = Adam(m.parameters(), 1e-3)
        if run.startswith("b"):
            s = st.TrainStep(cfg, m, opt)
        else:
            cls = (tt.FeedbackTrainStep if run.endswith("feedback")
                   else tt.TrainStep)
            s = cls(m, opt, cfg.label_smoothing)
        loss = s.loss(*(a.to(dev) for a in batch))
        loss = loss[0] if isinstance(loss, tuple) else loss
        loss.backward()
        return float(loss), {path: (p.grad if p.grad is not None
                                    else torch.zeros_like(p)).detach()
                             .cpu().double()
                             for path, p, _, _ in param_entries(m)}

    cfg16 = load_config({**raw, "compute_dtype": "bfloat16"})
    cfg32 = load_config(raw)
    cpu16 = model_of(cfg16).train()
    card = copy.deepcopy(cpu16).cuda().train()
    l16, g16 = step(cpu16, cfg16, "cpu")
    fp32_before = (gk.gru_sequence.launches,
                   gk.gru_sequence_backward.launches)
    lc, gc = step(card, cfg16, "cuda")
    torch.cuda.synchronize()
    assert (gk.gru_sequence.launches,
            gk.gru_sequence_backward.launches) == fp32_before
    l32, g32 = step(model_of(cfg32).train(), cfg32, "cpu")
    top = max(float(g.norm()) for g in g16.values())
    reading = {"run": run, "seed": seed,
               "tol": (BF16_CARD_LOSS_TOL, BF16_CARD_TOL),
               "loss_rel": abs(lc - l16) / abs(l16),
               "loss_rel_vs_fp32": abs(l16 - l32) / abs(l32), "grads": {}}
    for path, want in g16.items():
        cancelled = path[-2:] in (("k", "bias"), ("pre_linear", "bias")) \
            or path == ("encoder", "decoder", "bias")
        scale = top if cancelled else float(want.norm())
        if scale == 0.0:
            assert not gc[path].any(), "/".join(path)
            continue
        reading["grads"]["/".join(path)] = (
            float((gc[path] - want).norm()) / scale,
            float((want - g32[path]).norm()) / scale,
            float((gc[path] - g32[path]).norm()) / scale)
    print("bf16_card_vs_cpu " + json.dumps(reading))
    assert reading["loss_rel"] <= BF16_CARD_LOSS_TOL
    for name, (err, _, _) in reading["grads"].items():
        assert err <= BF16_CARD_TOL, f"{name}: {err}"


@pytest.mark.gpu
@pytest.mark.parametrize("run", ["a_vqvae", "b_ssl"])
def test_frame_and_similarity_steps_on_card_match_cpu(run):
    """One train step on the card against the CPU from the same weights
    and batch, dropout off (the VAEs sample their mean): the VQ frame
    model with VAE heads at the shipped widths (135 -> 40, 80 codes, its
    argmin through the VQ kernel, once) and the similarity step of a VAE
    tokenizer (its BiGRU through the GRU kernels at B=16 and, for the
    pairs, B=3): the loss and every gradient within 1e-4 of each tensor's
    largest magnitude (a bias in front of a batch-statistics BatchNorm, of
    the model's largest), and every buffer the step updates (BatchNorm
    statistics, the EMA state) within 1e-4 of the larger of 1 and its
    largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import copy

    from gesture2vec_tpu_torch.compat.from_jax import param_entries
    from gesture2vec_tpu_torch.ops.vq_kernel import vq_argmin
    from gesture2vec_tpu_torch.train import dae_trainer as dt
    from gesture2vec_tpu_torch.train import seq_ae_trainer as st
    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.train.optim import Adam

    rng = np.random.default_rng(4)
    if run == "a_vqvae":
        cfg = load_config({"hidden_size": 40, "input_motion_dim": 135,
                           "autoencoder_vq": True, "autoencoder_vae": True,
                           "autoencoder_vq_components": 80})
        cpu = dt.init_model(dt.make_frame_model(cfg), 0, torch.device("cpu"))
        batch = [torch.from_numpy(rng.normal(size=(128, 135)).astype(
            np.float32))]
        cancelled = {("encoder", "bias")}
    else:
        cfg = load_config({
            "hidden_size": 32, "n_layers": 2, "rep_learning_dim": 8,
            "n_poses": 10, "n_pre_poses": 1, "autoencoder_vq": True,
            "autoencoder_vq_components": 16, "autoencoder_vae": True,
            "use_similarity": True, "loss_label_weight": 0.1,
            "epochs": 20})
        cpu = dt.init_model(st.make_seq_ae(cfg), 0, torch.device("cpu"))
        batch = [torch.from_numpy(rng.normal(size=(n, 10, 8)).astype(
            np.float32)) for n in (16, 3, 3)]
        batch += [torch.tensor([1.0, 0.0, 1.0]), torch.tensor(12.0)]
        cancelled = {("decoder_step", "pre_linear", "bias")}
    cpu.train()
    card = copy.deepcopy(cpu).cuda().train()
    grads, losses, buffers = [], [], []
    before = vq_argmin.launches
    for m, dev in ((cpu, "cpu"), (card, "cuda")):
        opt = Adam(m.parameters(), 1e-3)
        step = (dt.TrainStep(m, opt) if run == "a_vqvae"
                else st.SSLTrainStep(cfg, m, opt))
        loss = step.loss(*(a.to(dev) for a in batch))
        loss = loss[0] if isinstance(loss, tuple) else loss
        loss.backward()
        losses.append(float(loss))
        grads.append({path: p.grad.detach().cpu()
                      for path, p, _, _ in param_entries(m)
                      if p.grad is not None})
        buffers.append({n: b.detach().cpu() for n, b in m.named_buffers()
                        if b.dtype.is_floating_point})
    torch.cuda.synchronize()
    assert vq_argmin.launches == before + (run == "a_vqvae")
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
    top = max(float(g.abs().max()) for g in grads[0].values())
    for path, g in grads[0].items():
        scale = top if path in cancelled else float(g.abs().max())
        err = float((grads[1][path] - g).abs().max())
        assert err <= 1e-4 * max(scale, 1e-30), ("/".join(path), err)
    for name, b in buffers[0].items():
        err = float((buffers[1][name] - b).abs().max())
        assert err <= 1e-4 * max(1.0, float(b.abs().max())), (name, err)
