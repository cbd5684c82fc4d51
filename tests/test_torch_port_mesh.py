"""PyTorch port vs the JAX package: training over a mesh (`mesh_shape`).

The port's counterparts of tests/test_mesh_training.py's trainer tests,
of test_audio2token.py's dp run, of test_vq.py's EMA psum and of
test_seq_ae.py's refusal of mesh + similarity. The port's ranks are gloo
processes on the CPU (`parallel/launch`): every meshed run of this file
takes one set of 4 ranks (`launch.call_all`), dp=4 or dp=2 x tp=2 (the
JAX tests use 8 virtual devices; dp=4 x tp=2 becomes dp=2 x tp=2).

Each meshed run is held against
  - the port's single run with the same generator, dropout on: the
    histories within rtol 1e-4 (the dp ranks draw the global batch's
    masks and keep their rows; BatchNorm takes the global batch's
    statistics);
  - where the JAX test compares numbers, JAX's own meshed run on the same
    numpy inputs from the port's initial weights (carried into the JAX
    trainer's init_state), every dropout off on both sides (flax's
    Dropout patched to the identity, the port's run inside
    `tests/torch_mesh_ranks.dropout_patched_off`: the models' fixed-rate
    dropouts, such as the tokenizer decoder's 0.95 step dropout, ignore
    dropout_prob):
    train losses within rtol 1e-4, val_acc within 2/48 (as
    test_mesh_training.py allows).
The baseline's and c2g's validation loss reads the decoder's pre_linear
bias, whose gradient in front of the batch-statistics BatchNorm is
rounding that Adam turns into steps of +-lr (see
tests/test_torch_port_train_misc.py): a dp run's rounding differs from
the single run's, so their val_loss is held within rtol 1e-3.
"""
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.compat.from_jax import to_jax_variables
from gesture2vec_tpu_torch.models.vq import VQEmaState
from gesture2vec_tpu_torch.parallel import launch
from gesture2vec_tpu_torch.train import audio2token_trainer as pa2t
from gesture2vec_tpu_torch.train import dae_trainer as pdae
from gesture2vec_tpu_torch.train import gan_trainer as pgan
from gesture2vec_tpu_torch.train import misc_trainers as pmisc
from gesture2vec_tpu_torch.train import seq_ae_trainer as pseq
from gesture2vec_tpu_torch.train import text2token_trainer as pt2t
from gesture2vec_tpu_torch.train.config import load_config
from tests.torch_mesh_ranks import call_without_dropout, vq_ema_on_ranks

RTOL, VAL_BN_RTOL, ACC_ATOL = 1e-4, 1e-3, 2.0 / 48 + 1e-9
DPTP = {"dp": 2, "tp": 2}
DP4 = {"dp": 4}

SEQ = dict(name="m", model="seq2seq", hidden_size=12, n_layers=2,
           dropout_prob=0.0, epochs=1, batch_size=16, learning_rate=0.002,
           rep_learning_dim=12, n_poses=8, n_pre_poses=1,
           autoencoder_vq=True, autoencoder_vq_components=8,
           autoencoder_att=False, autoencoder_conditioned=True,
           random_seed=0)
SEQ_TRAINS = {**SEQ, "hidden_size": 16, "dropout_prob": 0.1, "epochs": 2,
              "autoencoder_vq_components": 16}
RVQ = {**SEQ, "name": "mrvq", "autoencoder_vq_variant": "rvq",
       "rvq_stages": 2}
DAE = dict(name="dae_m", model="DAE", hidden_size=10, epochs=2,
           batch_size=32, learning_rate=0.002, dropout_prob=0.2,
           input_motion_dim=24, random_seed=0)
T2T = dict(name="t2t_m", model="seq2seq", hidden_size=16, n_layers=1,
           dropout_prob=0.0, epochs=2, batch_size=16, learning_rate=0.002,
           n_poses=8, n_pre_poses=1, sentence_frame_length=32,
           autoencoder_vq_components=16, autoencoder_att=True,
           wordembed_dim=8, random_seed=0)
MISC = dict(name="m3", model="seq2seq", hidden_size=16, n_layers=1,
            dropout_prob=0.1, epochs=2, batch_size=16, learning_rate=0.002,
            n_poses=8, n_pre_poses=1, wordembed_dim=8, noise_dim=8,
            autoencoder_vq_components=16, random_seed=0)
A2T = dict(name="a2t_m", model="seq2seq", hidden_size=16, n_layers=1,
           dropout_prob=0.1, epochs=2, batch_size=8, learning_rate=0.002,
           n_poses=8, n_pre_poses=1, sentence_frame_length=16,
           autoencoder_vq_components=16, autoencoder_att=True,
           random_seed=0)


def _windows(seed, n, t=8, d=12):
    from tests.fixtures import make_smooth_windows
    return make_smooth_windows(np.random.default_rng(seed), n=n, t=t, d=d)


def _frames():
    return np.random.default_rng(1).normal(size=(256, 24)).astype(
        np.float32)


def _t2t_data():
    rng = np.random.default_rng(2)
    n, s, steps = 64, 12, 4
    data = {"word_ids": rng.integers(4, 40, size=(n, s)).astype(np.int32),
            "lengths": np.full((n,), s, np.int32),
            "tokens": rng.integers(0, 16, size=(n, steps)).astype(np.int32)}
    return data, {k: v[:16] for k, v in data.items()}


def _misc_data():
    rng = np.random.default_rng(3)
    n, s, t, d = 64, 10, 8, 12
    data = {"word_ids": rng.integers(4, 30, size=(n, s)).astype(np.int32),
            "lengths": np.full((n,), s, np.int32),
            "poses": rng.normal(size=(n, t, d)).astype(np.float32)}
    ids = rng.integers(0, 16, size=(n,)).astype(np.int32)
    lat = rng.normal(size=(n, t, d)).astype(np.float32)
    return data, ids, lat


def _a2t_data():
    rng = np.random.default_rng(4)
    data = {"mel": rng.normal(size=(32, 2, 128, 32)).astype(np.float32),
            "tokens": rng.integers(0, 16, size=(32, 2)).astype(np.int32)}
    return data, {k: v[:16] for k, v in data.items()}


def _ema_inputs():
    x = np.random.default_rng(5).normal(size=(64, 4)).astype(np.float32)
    g = torch.Generator().manual_seed(2)
    cb = (torch.rand(8, 4, generator=g) * 2 - 1) / 8
    return torch.from_numpy(x), VQEmaState(cb, torch.zeros(8),
                                           torch.randn(8, 4, generator=g))


def _jobs():
    """Every meshed run of this file, in one set of 4 gloo ranks."""
    cpu = {"device": "cpu"}
    w, w32 = _windows(0, 64), _windows(6, 32)
    data, val = _t2t_data()
    mdata, ids, lat = _misc_data()
    mval = {k: v[:16] for k, v in mdata.items()}
    adata, aval = _a2t_data()
    x, st = _ema_inputs()
    frames = _frames()
    return {
        "seq_trains": (pseq.train_seq_ae, (load_config(
            {**SEQ_TRAINS, "mesh_shape": DPTP}), w, w[:16]), cpu),
        "seq_jax": (call_without_dropout, (pseq.train_seq_ae, load_config(
            {**SEQ, "mesh_shape": DP4}), w32, w32[:16]), cpu),
        "rvq_jax": (call_without_dropout, (pseq.train_seq_ae, load_config(
            {**RVQ, "mesh_shape": DPTP}), w32, w32[:16]), cpu),
        "dae_drop": (pdae.train_dae, (load_config(
            {**DAE, "mesh_shape": DP4}), frames, frames[:32]), cpu),
        "vqframe": (pdae.train_dae, (load_config(
            {**DAE, "autoencoder_vq": True, "autoencoder_vae": True,
             "autoencoder_vq_components": 8, "mesh_shape": DPTP}), frames,
            frames[:32]), cpu),
        "t2t_jax": (call_without_dropout, (pt2t.train_text2token,
                                           load_config(
            {**T2T, "mesh_shape": DPTP}), data, val, 40), cpu),
        "t2t_drop": (pt2t.train_text2token, (load_config(
            {**T2T, "dropout_prob": 0.1, "mesh_shape": DPTP}), data, val,
            40), cpu),
        "baseline": (pmisc.train_baseline, (load_config(
            {**MISC, "mesh_shape": DPTP}), mdata, mval, 30), cpu),
        "c2g": (pmisc.train_c2g, (load_config(
            {**MISC, "mesh_shape": DP4}), ids, lat, ids[:16], lat[:16]),
            cpu),
        "gan": (pgan.train_gan, (load_config(
            {**MISC, "epochs": 1, "mesh_shape": DPTP}), mdata, 30), cpu),
        "audio": (pa2t.train_audio2token, (load_config(
            {**A2T, "mesh_shape": DP4}), adata, aval), cpu),
        "vq_ema": (vq_ema_on_ranks, (x, st, DP4), {}),
    }


@pytest.fixture(scope="module")
def meshed():
    """{name: rank 0's result} of every job, from one launch."""
    jobs = _jobs()
    names = list(jobs)
    got = launch.run(launch.call_all, ([jobs[k] for k in names],),
                     world_size=4, device="cpu")
    return dict(zip(names, got))


def _single(name):
    """The job's run without its mesh, in this process."""
    fn, args, kw = _jobs()[name]
    args = [a.replace(mesh_shape=None) if hasattr(a, "mesh_shape") else a
            for a in args]
    return fn(*args, **kw)


def _close(got, want, keys=None, rtol=RTOL, loose=()):
    for k in keys or want:
        np.testing.assert_allclose(got[k], want[k],
                                   rtol=VAL_BN_RTOL if k in loose else rtol,
                                   err_msg=k)


def _jax_from_port(monkeypatch, jmod, port_model):
    """The JAX trainer's init_state with the port's initial weights (its
    optimizer state is zeros either way), and flax's Dropout the
    identity (the port's side runs inside `dropout_patched_off`)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    v = to_jax_variables(port_model)
    real = jmod.init_state

    def init_state(*a, **k):
        st = real(*a, **k)
        tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa
        return st._replace(params=tree(v["params"]),
                           batch_stats=tree(v["batch_stats"]))
    monkeypatch.setattr(jmod, "init_state", init_state)


def _jax_cfg(raw, mesh):
    from gesture2vec_tpu.train.config import load_config as jload
    return jload({**raw, "mesh_shape": mesh})


def test_seq_ae_trains_on_mesh(meshed):
    """dp=2 x tp=2 (the codebook row-sharded), dropout 0.1: the port's
    single run's history, and the JAX test's finite, falling loss."""
    _, hist = meshed["seq_trains"]
    _, single = _single("seq_trains")
    _close(hist, single)
    assert np.isfinite(hist["train_loss"]).all()
    assert hist["train_loss"][-1] < hist["train_loss"][0]


@pytest.mark.parametrize("name", ["dae_drop", "vqframe"])
def test_dae_mesh_matches_single_device(meshed, name):
    """Part a: the DAE over dp=4 and the VQ-VAE frame model over dp=2 x
    tp=2 (its EMA codebook row-sharded, the EMA statistics summed over
    dp, the VAE noise drawn at the global batch's shape): the single
    run's history, input dropout on (the Part-a models' fixed 0.2 / 0.5,
    which dropout_prob does not switch off; JAX's masks are other bits,
    so the JAX side is JAX's own test_dae_mesh_matches_single_device)."""
    _close(meshed[name][1], _single(name)[1])


def test_text2token_mesh_matches_single_device(meshed, monkeypatch):
    """Part d over dp=2 x tp=2 (the word table row-sharded): JAX's run
    from the same weights (train loss, val_acc within 2/48); dropout 0.1
    the single run's history."""
    from gesture2vec_tpu.train import text2token_trainer as jt2t

    _close(meshed["t2t_drop"][1], _single("t2t_drop")[1])
    cfg = load_config(T2T)
    _jax_from_port(monkeypatch, jt2t, pt2t.init_text2token(
        pt2t.make_text2token(cfg, 40), 0, torch.device("cpu")))
    data, val = _t2t_data()
    _, want = jt2t.train_text2token(_jax_cfg(T2T, DPTP), data, val,
                                    n_words=40)
    got = meshed["t2t_jax"][1]
    _close(got, want, ("train_loss",))
    np.testing.assert_allclose(got["val_acc"], want["val_acc"],
                               atol=ACC_ATOL)


@pytest.mark.parametrize("name", ["baseline", "c2g", "gan"])
def test_baseline_c2g_gan_train_on_mesh(meshed, name):
    """The remaining trainers over dp=2 x tp=2 (the baseline's and the
    GAN's word tables row-sharded) or dp=4 (c2g), dropout 0.1: the single
    run's history (val_loss: see the module note); finite, and the
    baseline's loss falls, as in the JAX test."""
    _, hist = meshed[name]
    _close(hist, _single(name)[1], loose=("val_loss",))
    key = "g_loss" if name == "gan" else "train_loss"
    assert np.isfinite(hist[key]).all()
    if name == "baseline":
        assert hist[key][-1] < hist[key][0]


def test_dryrun_multichip_self_provisions():
    """The port's dry run starts its own 4 gloo ranks from a plain process
    and runs every trainer, the pipeline and the sp sweep over them."""
    from gesture2vec_tpu_torch.parallel.dryrun import dryrun_multichip

    lines = dryrun_multichip(4)
    assert len(lines) == 11 and all("OK" in line for line in lines)


def test_mesh_matches_single_device(meshed, monkeypatch):
    """Part b over dp=4, dropout 0: the single run's history and JAX's
    dp=4 run's train loss from the same weights."""
    from gesture2vec_tpu.train import seq_ae_trainer as jseq

    got = meshed["seq_jax"][1]
    _close(got, _single("seq_jax")[1])
    _jax_from_port(monkeypatch, jseq, pdae.init_model(
        pseq.make_seq_ae(load_config(SEQ)), 0, torch.device("cpu")))
    w = _windows(6, 32)
    _, want = jseq.train_seq_ae(_jax_cfg(SEQ, DP4), w, w[:16])
    _close(got, want, ("train_loss",))


def test_rvq_mesh_matches_single_device(meshed, monkeypatch):
    """The residual VQ over dp=2 x tp=2 (both stage codebooks
    row-sharded, each stage's argmin on its shard): the single run's
    history and JAX's run's train loss from the same weights."""
    from gesture2vec_tpu.train import seq_ae_trainer as jseq

    got = meshed["rvq_jax"][1]
    _close(got, _single("rvq_jax")[1])
    _jax_from_port(monkeypatch, jseq, pdae.init_model(
        pseq.make_seq_ae(load_config(RVQ)), 0, torch.device("cpu")))
    w = _windows(6, 32)
    _, want = jseq.train_seq_ae(_jax_cfg(RVQ, DPTP), w, w[:16])
    _close(got, want, ("train_loss",))


def test_audio2token_mesh_matches_single_device(meshed):
    """The audio trainer over dp=4 (its encoder's BatchNorms on the global
    batch), dropout 0.1: the single run's history."""
    _close(meshed["audio"][1], _single("audio")[1])


def test_vq_ema_dp_psum_equivalence(meshed):
    """The EMA update over dp=4 (counts and sums all-reduced,
    axis_name=mesh) equals the single update on the global batch, and
    JAX's."""
    import jax.numpy as jnp

    from gesture2vec_tpu.models.vq import VQEmaState as JState
    from gesture2vec_tpu.models.vq import vq_ema as jvq_ema
    from gesture2vec_tpu_torch.models.vq import vq_ema

    x, st = _ema_inputs()
    _, ref = vq_ema(x, st, train=True)
    got = meshed["vq_ema"]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    _, want = jvq_ema(jnp.asarray(x.numpy()), JState(
        *(jnp.asarray(t.numpy()) for t in st)), train=True)
    np.testing.assert_allclose(got.codebook.numpy(),
                               np.asarray(want.codebook), rtol=1e-5)
    np.testing.assert_allclose(got.cluster_size.numpy(),
                               np.asarray(want.cluster_size), rtol=1e-5)


def test_similarity_training_refuses_a_mesh(tmp_path):
    """mesh_shape with use_similarity raises the JAX package's ValueError
    (raised in the ranks, re-raised here)."""
    labels = tmp_path / "labels.txt"
    labels.write_text("a,0,1,2,1,0\n")
    cfg = load_config({**SEQ, "use_similarity": True,
                       "similarity_labels": str(labels),
                       "mesh_shape": {"dp": 2}})
    w = _windows(0, 32)
    with pytest.raises(ValueError, match="single-device"):
        pseq.train_seq_ae(cfg, w, w[:16], device="cpu")


@pytest.mark.parametrize("shape, match", [({"dp": 3}, "not divisible"),
                                          ({"tp": 3}, "tp=3")])
def test_indivisible_mesh_raises(shape, match):
    """A batch dp does not divide (before any rank starts), or a codebook
    tp does not divide (raised in the ranks, re-raised here), raises
    ValueError."""
    w = _windows(0, 32)
    with pytest.raises(ValueError, match=match):
        pseq.train_seq_ae(load_config({**SEQ, "mesh_shape": shape}), w,
                          w[:16], device="cpu")
