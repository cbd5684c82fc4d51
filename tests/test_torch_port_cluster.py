"""PyTorch port vs the JAX package: the Part-c path (corpus sweep,
K-Means, metrics, the cluster CLI).

A 3-clip train store and a 2-clip validation store are written by the
JAX package's ClipStoreWriter, and its checkpoints by its own
save_checkpoint (random, perturbed weights: a DAE, a GS-Soft tokenizer
and a 3-stage residual-VQ tokenizer). The port reads the same files.
Tokens must be identical, latents within 1e-5 (fp32 on both sides),
Lloyd's algorithm from the same initial centers must give identical
labels, and the CLIs' Metrics.txt must be identical.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.cluster import kmeans as port_km
from gesture2vec_tpu_torch.cluster import metrics as port_metrics
from gesture2vec_tpu_torch.cluster.latent_dataset import (
    build_latent_dataset, load_latent_dataset, save_latent_dataset,
    token_index)
from gesture2vec_tpu_torch.compat.checkpoint import load_checkpoint_and_model
from gesture2vec_tpu_torch.data.store import ClipStore
from gesture2vec_tpu_torch.data.teacher import tokenize_windows

ATOL = 1e-5
DIM, REP, HID, L, K, NP, STRIDE = 12, 8, 16, 2, 32, 8, 3


def perturb(tree, rng, scale=0.3):
    def leaf(path, x):
        x = np.asarray(x)
        noise = rng.normal(size=x.shape).astype(np.float32) * scale
        if getattr(path[-1], "key", None) == "var":
            return (np.abs(x + noise) + 0.5).astype(np.float32)
        return (x + noise).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _write_store(root, rng, lengths):
    from gesture2vec_tpu.data.store import ClipStoreWriter

    w = ClipStoreWriter(root)
    clips = [rng.normal(size=(n, DIM)) * 2 + 1 for n in lengths]
    for i, poses in enumerate(clips):
        w.add_clip(f"vid{i}", poses, words=[["hi", 0.0, 0.4]])
    frames = np.concatenate(clips)
    w.set_stats(frames.mean(0), frames.std(0))
    w.finish()
    return root


def _seq_cfg(variant, **kw):
    from gesture2vec_tpu.train.config import load_config

    return load_config(dict(name=f"vq_{variant}", model="seq2seq",
                            hidden_size=HID, n_layers=L, dropout_prob=0.1,
                            rep_learning_dim=REP, n_poses=NP, n_pre_poses=1,
                            subdivision_stride=STRIDE, autoencoder_vq=True,
                            autoencoder_vq_components=K,
                            autoencoder_vq_variant=variant, rvq_stages=3,
                            random_seed=0, **kw))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """JAX-written stores and checkpoints (paths only)."""
    from gesture2vec_tpu.train import checkpoints
    from gesture2vec_tpu.train import dae_trainer
    from gesture2vec_tpu.train.config import load_config
    from gesture2vec_tpu.train.optim import make_optimizer
    from gesture2vec_tpu.train.seq_ae_trainer import init_state, make_seq_ae

    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(11)
    out = {"train": _write_store(str(root / "train"), rng, (60, 71, 45)),
           "val": _write_store(str(root / "val"), rng, (50, 38))}
    dae_cfg = load_config(dict(name="dae", model="DAE", hidden_size=REP,
                               input_motion_dim=DIM, autoencoder_vq=False,
                               autoencoder_vae=False, random_seed=0))
    dae = dae_trainer.make_frame_model(dae_cfg)
    st = dae_trainer.init_state(dae_cfg, dae, jax.random.PRNGKey(1),
                                make_optimizer(1e-3))
    out["dae"] = str(root / "dae.bin")
    params = perturb(jax.tree_util.tree_map(np.asarray, st.params), rng)
    checkpoints.save_checkpoint(out["dae"], config=dae_cfg, epoch=1,
                                params=params, pose_dim=DIM, kind="DAE")
    for variant in ("gssoft", "rvq"):
        cfg = _seq_cfg(variant)
        model = make_seq_ae(cfg)
        st = init_state(cfg, model, jax.random.PRNGKey(2),
                        make_optimizer(1e-3))
        tree = perturb(jax.tree_util.tree_map(
            np.asarray, {"params": st.params,
                         "batch_stats": st.batch_stats}), rng)
        if variant == "rvq":
            # codebooks at the scale of the tanh-bounded hidden, so that
            # the hard argmin does not pick the shortest code every time
            vq = tree["params"]["vq_layer"]
            for name in vq:
                vq[name] = vq[name] * np.float32(0.1)
        out[variant] = str(root / f"{variant}.bin")
        checkpoints.save_checkpoint(
            out[variant], config=cfg, epoch=1, params=tree["params"],
            pose_dim=REP, extra={"batch_stats": tree["batch_stats"],
                                 "parity": False},
            kind="autoencoder_vq")
    out["root"] = str(root)
    return out


def _jax_models(corpus, variant):
    from gesture2vec_tpu.train import checkpoints

    dae, dae_v, _ = checkpoints.load_checkpoint_and_model(corpus["dae"],
                                                          "DAE")
    seq, seq_v, _ = checkpoints.load_checkpoint_and_model(corpus[variant],
                                                          "autoencoder_vq")
    return dae, dae_v, seq, seq_v


def _port_models(corpus, variant):
    dae, _ = load_checkpoint_and_model(corpus["dae"], "DAE", "cpu")
    seq, _ = load_checkpoint_and_model(corpus[variant], "autoencoder_vq",
                                       "cpu")
    return dae, seq


@pytest.mark.parametrize("variant", ["gssoft", "rvq"])
def test_latent_dataset_matches_jax(corpus, variant):
    from gesture2vec_tpu.cluster.latent_dataset import \
        build_latent_dataset as jax_build
    from gesture2vec_tpu.data.store import ClipStore as JaxStore

    dae, dae_v, seq, seq_v = _jax_models(corpus, variant)
    want = jax_build(JaxStore(corpus["train"]), dae_model=dae,
                     dae_variables=dae_v, seq_model=seq,
                     seq_variables=seq_v, n_poses=NP, stride=STRIDE)
    p_dae, p_seq = _port_models(corpus, variant)
    got = build_latent_dataset(ClipStore(corpus["train"]), dae_model=p_dae,
                               seq_model=p_seq, n_poses=NP, stride=STRIDE)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["windows"], want["windows"])
    np.testing.assert_allclose(got["dae_latents"], want["dae_latents"],
                               atol=ATOL)
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert len(np.unique(got["tokens"])) > 1
    np.testing.assert_allclose(got["seq_latents"], want["seq_latents"],
                               atol=ATOL)


@pytest.mark.parametrize("batch", [512, 7])
def test_tokenize_all_stages_matches_jax(corpus, rng, batch):
    """Residual stage tokens, with one padded batch and with many
    ragged ones."""
    from gesture2vec_tpu.data.teacher import tokenize_windows as jax_tok

    _, _, seq, seq_v = _jax_models(corpus, "rvq")
    _, p_seq = _port_models(corpus, "rvq")
    lat = rng.normal(size=(30, NP, REP)).astype(np.float32)
    tj, lj = jax_tok(seq, seq_v, lat, batch=batch, all_stages=True)
    tp, lp = tokenize_windows(p_seq, lat, batch=batch, all_stages=True)
    assert tp.shape == (30, 3)
    np.testing.assert_array_equal(tp, np.asarray(tj))
    np.testing.assert_allclose(lp, np.asarray(lj), atol=ATOL)


def _blobs(rng, n_per=40, d=6, centers=((0,) * 6, (5,) * 6, (-5,) * 6)):
    c = np.asarray(centers, np.float32)
    return np.concatenate([ci + rng.normal(size=(n_per, d))
                           for ci in c]).astype(np.float32)


def test_lloyd_from_jax_seeding_matches_kmeans_fit(rng):
    from gesture2vec_tpu.cluster import kmeans as jax_km

    x = rng.normal(size=(300, 6)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    c0 = np.array(jax_km._plusplus_init(jax.random.split(key, 1)[0],
                                          jnp.asarray(x), 7))
    want = jax_km.kmeans_fit(x, 7, key=key, n_init=1)
    centers, labels, inertia, steps = port_km.lloyd(torch.from_numpy(x),
                                                    torch.from_numpy(c0))
    assert steps > 1
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(centers.numpy(), np.asarray(want.centers),
                               atol=ATOL)
    np.testing.assert_allclose(inertia.item(), float(want.inertia),
                               rtol=ATOL)
    np.testing.assert_array_equal(
        port_km.kmeans_predict(x, centers, device="cpu").numpy(),
        np.asarray(jax_km.kmeans_predict(x, want.centers)))


def test_lloyd_relocates_empty_clusters_like_jax(rng, monkeypatch):
    """Three initial centers far from every point get no points in the
    first step and take the farthest points instead, in order."""
    from gesture2vec_tpu.cluster import kmeans as jax_km

    x = _blobs(rng)
    c0 = np.concatenate([x[[0, 40, 80]],
                         np.full((3, 6), 100.0, np.float32)])
    monkeypatch.setattr(jax_km, "_plusplus_init",
                        lambda key, xs, k: jnp.asarray(c0))
    want = jax_km.kmeans_fit(x, 6, key=jax.random.PRNGKey(0), n_init=1)
    xt = torch.from_numpy(x)
    first = port_km.lloyd_step(xt, torch.from_numpy(c0))
    assert not (first.numpy() == 100.0).any()
    centers, labels, inertia, _ = port_km.lloyd(xt, torch.from_numpy(c0))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(centers.numpy(), np.asarray(want.centers),
                               atol=ATOL)
    assert np.bincount(labels.numpy(), minlength=6).min() > 0


def test_kmeans_fit_finds_blobs_and_keeps_the_best_init(rng):
    x = _blobs(rng)
    res = port_km.kmeans_fit(x, 3, seed=0, n_init=4, device="cpu")
    labels = res.labels.numpy()
    for i in range(3):
        assert (labels[i * 40:(i + 1) * 40] == labels[i * 40]).all()
    assert len(res.n_iter) == 4 and min(res.n_iter) >= 1
    again = port_km.kmeans_fit(x, 3, seed=0, n_init=4, device="cpu")
    np.testing.assert_array_equal(again.centers.numpy(),
                                  res.centers.numpy())
    inertias = [port_km.lloyd(torch.from_numpy(x), port_km.plusplus_init(
        torch.from_numpy(x), 3, torch.Generator().manual_seed(s)))[2].item()
        for s in range(3)]
    assert res.inertia.item() <= min(inertias) + 1e-3
    # more clusters than distinct points: seeding draws uniformly once
    # every point is a center, and no cluster stays empty for long
    dup = np.repeat(x[:2], 5, axis=0)
    small = port_km.kmeans_fit(dup, 4, seed=1, n_init=1, device="cpu")
    assert small.centers.shape == (4, 6)


def test_metrics_copies_match_jax(rng):
    from gesture2vec_tpu.cluster import metrics as jax_metrics

    a = rng.normal(size=(2500, 5))
    b = rng.normal(size=(300, 5)) + 0.3
    t1, t2 = rng.integers(0, 9, 400), rng.integers(0, 9, 300)
    assert port_metrics.hellinger(
        port_metrics.token_histogram(t1, 9),
        port_metrics.token_histogram(t2, 9)) == jax_metrics.hellinger(
        jax_metrics.token_histogram(t1, 9), jax_metrics.token_histogram(t2, 9))
    assert port_metrics.frechet_distance(a, b) == \
        jax_metrics.frechet_distance(a, b)
    assert port_metrics.token_perplexity(t1, 9) == \
        jax_metrics.token_perplexity(t1, 9)
    assert port_metrics.wasserstein_distance(t1, t2) == \
        jax_metrics.wasserstein_distance(t1, t2)
    for x in (a, b):        # the sampled (> 2000) and the exact branch
        assert port_metrics.representation_neighbor_distance(x) == \
            jax_metrics.representation_neighbor_distance(x)
    with pytest.raises(ValueError):
        port_metrics.representation_neighbor_distance(a[:4])


def test_latent_dataset_io_and_token_index(tmp_path, rng):
    data = {"tokens": rng.integers(0, 5, 20).astype(np.int32),
            "seq_latents": rng.normal(size=(20, 4)).astype(np.float32)}
    save_latent_dataset(str(tmp_path / "d.npz"), data)
    back = load_latent_dataset(str(tmp_path / "d.npz"))
    for k in data:
        np.testing.assert_array_equal(back[k], data[k])
    idx = token_index(data["tokens"], 6)
    assert sorted(np.concatenate(list(idx.values()))) == list(range(20))
    assert idx[5].size == 0


def test_cluster_cli_matches_jax_cli(corpus, monkeypatch):
    from gesture2vec_tpu.cli import cluster as jax_cli

    from gesture2vec_tpu_torch.cli import cluster as port_cli

    outs = {w: os.path.join(corpus["root"], f"clusters_{w}")
            for w in ("jax", "port")}
    common = [corpus["dae"], corpus["gssoft"], "--store", corpus["train"],
              "--val-store", corpus["val"]]
    monkeypatch.setattr(sys, "argv", ["cluster", *common, "--out",
                                      outs["jax"], "--jax-cache", "off"])
    jax_cli.main()
    summary = port_cli.main([*common, "--out", outs["port"], "--kmeans", "4",
                             "--device", "cpu"])
    assert summary["windows"] > 0 and summary["val_windows"] > 0
    assert len(summary["kmeans_n_iter"]) == 10
    read = {w: open(os.path.join(o, "Metrics.txt")).read()
            for w, o in outs.items()}
    assert read["port"] == read["jax"] and "Frechet" in read["port"]
    tex = {w: open(os.path.join(o, "Metrics.tex")).read()
           for w, o in outs.items()}
    assert tex["port"] == tex["jax"]
    npz = {w: load_latent_dataset(os.path.join(
        o, "org_latent_clustering_data.npz")) for w, o in outs.items()}
    np.testing.assert_array_equal(npz["port"]["tokens"],
                                  npz["jax"]["tokens"])
    np.testing.assert_array_equal(npz["port"]["windows"],
                                  npz["jax"]["windows"])
    for k in ("dae_latents", "seq_latents"):
        np.testing.assert_allclose(npz["port"][k], npz["jax"][k], atol=ATOL)
    rep = {w: dict(ln.split(": ") for ln in open(os.path.join(
        o, "Rep_distance.txt")).read().split("\n") if ln)
        for w, o in outs.items()}
    assert rep["port"].keys() == rep["jax"].keys()
    for k in rep["jax"]:
        assert abs(float(rep["port"][k]) - float(rep["jax"][k])) <= 2e-6
    with np.load(os.path.join(outs["port"], "kmeans_model.npz")) as z:
        assert z["centers"].shape == (4, L * HID)


def test_entry_points_need_cuda_unless_asked_for_cpu(corpus, monkeypatch):
    from gesture2vec_tpu_torch.cli import cluster as port_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((6, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_km.kmeans_fit(x, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_km.kmeans_predict(x, x[:2])
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint_and_model(corpus["dae"], "DAE")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.main([corpus["dae"], corpus["gssoft"], "--store",
                       corpus["train"], "--out",
                       os.path.join(corpus["root"], "no_card")])


def test_unported_options_raise(corpus, tmp_path):
    from gesture2vec_tpu.train import checkpoints

    from gesture2vec_tpu_torch.cli import cluster as port_cli
    from gesture2vec_tpu_torch.compat.checkpoint import load_checkpoint
    from gesture2vec_tpu_torch.data.teacher import encode_frames_with_dae

    common = [corpus["dae"], corpus["gssoft"], "--store", corpus["train"],
              "--device", "cpu"]
    # --plots, --export-samples and --algo are ported
    # (tests/test_torch_port_analysis.py); --export-samples still needs
    # --pipeline, as in JAX
    with pytest.raises(SystemExit):
        port_cli.main(common + ["--export-samples", "2"])
    payload = load_checkpoint(corpus["gssoft"])
    path = str(tmp_path / "autoencoder_att.bin")
    checkpoints.save_checkpoint(
        path, config=_seq_cfg("gssoft", autoencoder_att=True), epoch=1,
        params=payload["params"], extra=payload["extra"],
        kind="autoencoder_vq")
    # decoder attention loads (tests/test_torch_port_reconstruct.py), but
    # not over weights without it
    with pytest.raises(ValueError, match="autoencoder_att"):
        load_checkpoint_and_model(path, "autoencoder_vq", "cpu")
    # use_derivative and autoencoder_vae tokenizers load and tokenize as
    # JAX's do (the VAE heads play no part in the tokens)
    from gesture2vec_tpu.data.teacher import tokenize_windows as jax_tok
    from gesture2vec_tpu.train.seq_ae_trainer import make_seq_ae

    for kw in (dict(use_derivative=True), dict(autoencoder_vae=True)):
        cfg = _seq_cfg("gssoft", **kw)
        jm = make_seq_ae(cfg)
        dummy = jnp.zeros((2, NP, jm.rep_dim))
        variables = perturb(jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k: jm.init(k, dummy, dummy, train=False))(
            jax.random.PRNGKey(5))), np.random.default_rng(5), 0.1)
        path = str(tmp_path / f"{next(iter(kw))}.bin")
        checkpoints.save_checkpoint(
            path, config=cfg, epoch=1, params=variables["params"],
            extra={"batch_stats": variables["batch_stats"],
                   "parity": False}, kind="autoencoder_vq")
        model, _ = load_checkpoint_and_model(path, "autoencoder_vq", "cpu")
        lat = np.random.default_rng(6).normal(
            size=(30, NP, jm.rep_dim)).astype(np.float32)
        got, want = tokenize_windows(model, lat), jax_tok(jm, variables,
                                                          lat)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=ATOL)
    # seq_arch: transformer loads (the transformer chunk encoder), its
    # tokens JAX's; under BiGRU weights the config is refused
    from gesture2vec_tpu.data.teacher import tokenize_windows as jax_tok
    from gesture2vec_tpu.train.seq_ae_trainer import make_seq_ae

    cfg = _seq_cfg("gssoft", seq_arch="transformer")
    jm = make_seq_ae(cfg)
    dummy = jnp.zeros((2, NP, REP))
    tf_vars = perturb(jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jm.init(k, dummy, dummy, train=False))(
        jax.random.PRNGKey(3))), np.random.default_rng(3), 0.1)
    for params, name in ((tf_vars["params"], "tf.bin"),
                         (payload["params"], "tf_bigru.bin")):
        path = str(tmp_path / name)
        checkpoints.save_checkpoint(
            path, config=cfg, epoch=1, params=params,
            extra={"batch_stats": tf_vars["batch_stats"], "parity": False},
            kind="autoencoder_vq")
    tf, _ = load_checkpoint_and_model(str(tmp_path / "tf.bin"),
                                      "autoencoder_vq", "cpu")
    lat = np.random.default_rng(4).normal(size=(20, NP, REP)).astype(
        np.float32)
    np.testing.assert_array_equal(tokenize_windows(tf, lat)[0], np.asarray(
        jax_tok(jm, tf_vars, lat)[0]))
    with pytest.raises(ValueError, match="seq_arch transformer"):
        load_checkpoint_and_model(str(tmp_path / "tf_bigru.bin"),
                                  "autoencoder_vq", "cpu")
    path = str(tmp_path / "no_vq.bin")
    checkpoints.save_checkpoint(
        path, config=_seq_cfg("gssoft").replace(autoencoder_vq=False),
        epoch=1, params=payload["params"], extra=payload["extra"])
    with pytest.raises(ValueError, match="no quantizer"):
        load_checkpoint_and_model(path, "autoencoder_vq", "cpu")
    # a VQFrame DAE (its BatchNorm statistics and EMA state in the file)
    # encodes frames as JAX's: the raw encoder output
    from gesture2vec_tpu.data.teacher import encode_frames_with_dae as jenc
    from gesture2vec_tpu.train import dae_trainer
    from gesture2vec_tpu.train.config import load_config
    from gesture2vec_tpu.train.optim import make_optimizer

    dae_payload = load_checkpoint(corpus["dae"])
    cfg = load_config({**dae_payload["config"], "autoencoder_vq": True,
                       "autoencoder_vq_components": 16})
    jm = dae_trainer.make_frame_model(cfg)
    st = dae_trainer.init_state(cfg, jm, jax.random.PRNGKey(7),
                                make_optimizer(1e-3))
    variables = perturb({"params": st.params,
                         "batch_stats": st.batch_stats},
                        np.random.default_rng(7))
    vq_dae = str(tmp_path / "vq_dae.bin")
    checkpoints.save_checkpoint(
        vq_dae, config=cfg, epoch=1, params=variables["params"],
        extra={"batch_stats": variables["batch_stats"],
               "vq_state": jax.tree_util.tree_map(
                   np.asarray, st.vq_state._asdict())}, kind="DAE")
    vq_frame, _ = load_checkpoint_and_model(vq_dae, "DAE", "cpu")
    frames = np.random.default_rng(8).normal(size=(50, DIM)).astype(
        np.float32)
    np.testing.assert_allclose(
        encode_frames_with_dae(vq_frame, frames),
        np.asarray(jenc(jm, variables, frames)), atol=ATOL)
    # every kind of the JAX registry loads since c2g's came (tests/
    # test_torch_port_train_misc.py); a kind outside it is refused
    with pytest.raises(KeyError, match="unknown checkpoint kind"):
        load_checkpoint_and_model(corpus["dae"], "no_such_kind", "cpu")
    # the sweep over a mesh (3 frames over sp=2: padded, split, trimmed)
    # is the sweep without one
    from gesture2vec_tpu_torch.parallel.mesh import make_mesh
    dae, _ = load_checkpoint_and_model(corpus["dae"], "DAE", "cpu")
    np.testing.assert_allclose(
        encode_frames_with_dae(dae, frames[:3], mesh=make_mesh({"sp": 2},
                                                               "cpu")),
        encode_frames_with_dae(dae, frames[:3]), rtol=0, atol=1e-6)
