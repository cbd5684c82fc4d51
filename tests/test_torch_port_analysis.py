"""PyTorch port vs the JAX package: the analysis paths - the rest of
`cluster/` (decode_codebook, export_cluster_samples, analysis, mapdp,
plots, BLEU, load_kmeans), `mocap/viz`, the cluster CLI's `--plots`,
`--export-samples` / `--pipeline` and `--algo`, `g2v-train
--plot-every` and its loss curves, `g2v-infer --plot-attention`, and
decode-mode generation over a parity tokenizer (its eval step dropout,
both packages fed one numpy mask stream).

A synthetic Trinity-layout corpus (2 BVH files, 120 frames at 20 fps,
135-wide features) goes through the port's ingest, whose train store
gives 46 windows of 10 poses; the checkpoints are written in the JAX
package's format from the port's modules initialised as flax would
(`compat/from_jax.flax_init`, then perturbed): a DAE (latent 8), a
GS-Soft tokenizer (hidden 16, 2 layers, 8 codes) and a TCN Part d with
attention. Floats within 1e-5 of JAX's, labels and text files identical;
the BVH exports as in `tests/test_torch_port_reconstruct.py` (the
exporter exact on JAX's frames, the motion within MOTION_TOL, the number
of differing values printed). t-SNE runs on at most 50 points.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.cli import cluster as p_cluster
from gesture2vec_tpu_torch.cli import make_dataset as p_make_dataset
from gesture2vec_tpu_torch.cluster import analysis as p_analysis
from gesture2vec_tpu_torch.cluster import kmeans as p_km
from gesture2vec_tpu_torch.cluster import metrics as p_metrics
from gesture2vec_tpu_torch.cluster import plots as p_plots
from gesture2vec_tpu_torch.cluster.latent_dataset import (
    build_latent_dataset, decode_codebook, export_cluster_samples)
from gesture2vec_tpu_torch.compat.checkpoint import load_checkpoint_and_model
from gesture2vec_tpu_torch.data.store import ClipStore
from gesture2vec_tpu_torch.io.bvh import parse_bvh
from gesture2vec_tpu_torch.mocap import viz as p_viz
from gesture2vec_tpu_torch.mocap.features import FeatureExtractor
from tests.corpus import make_corpus
from tests.test_torch_port_reconstruct import (  # noqa: F401
    MOTION_TOL, _init_variables, _seq_cfg, _split, torch_one_thread)

ATOL = 1e-5
DIM, REP, HID, L, K, NP, STRIDE = 135, 8, 16, 2, 8, 10, 5
SENT, WEMB = 40, 12


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The ingested corpus and the checkpoints (paths)."""
    from gesture2vec_tpu.train import checkpoints
    from gesture2vec_tpu.train.config import load_config

    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.text.vocab import build_vocab
    from gesture2vec_tpu_torch.train.config import load_config as p_config
    from gesture2vec_tpu_torch.train.seq_ae_trainer import make_seq_ae
    from gesture2vec_tpu_torch.train.text2token_trainer import \
        make_text2token

    root = tmp_path_factory.mktemp("analysis")
    corpus = make_corpus(str(root / "corpus"), n_files=2, n_frames=360)
    train, val = p_make_dataset.main([corpus, "--out", str(root / "data")])
    out = {"root": root, "train": train, "val": val, "corpus": corpus,
           "pipeline": str(root / "data" / "data_pipe.json"),
           "dae": str(root / "dae.bin"), "vq": str(root / "vq.bin"),
           "t2t": str(root / "t2t.bin")}
    checkpoints.save_checkpoint(
        out["dae"], config=load_config(dict(
            name="dae", model="DAE", hidden_size=REP, input_motion_dim=DIM,
            random_seed=0)), epoch=1,
        params=_init_variables(DAE(DIM, REP), 1, 0.1)["params"],
        pose_dim=DIM, kind="DAE")
    tree = _init_variables(make_seq_ae(p_config(_seq_cfg())), 2)
    checkpoints.save_checkpoint(
        out["vq"], config=load_config(_seq_cfg()), epoch=1,
        params=tree["params"], pose_dim=REP,
        extra={"batch_stats": tree["batch_stats"], "parity": False},
        kind="autoencoder_vq")
    vocab = build_vocab("corpus", [[w[0] for w in c["words"]]
                                   for c in ClipStore(train).clips])
    t2t_cfg = dict(name="t2t", model="seq2seq", hidden_size=HID, n_layers=L,
                   n_poses=NP, sentence_frame_length=SENT, n_pre_poses=2,
                   autoencoder_vq_components=K, autoencoder_att=True,
                   wordembed_dim=WEMB, motion_resampling_framerate=20,
                   random_seed=0)
    torch.manual_seed(0)
    tree = _init_variables(make_text2token(p_config(t2t_cfg),
                                           vocab.n_words), 3, 0.1)
    checkpoints.save_checkpoint(
        out["t2t"], config=load_config(t2t_cfg), epoch=1,
        params=tree["params"], lang_model=vocab.state_dict(),
        extra={"batch_stats": tree["batch_stats"],
               "n_words": vocab.n_words}, kind="text2embedding")
    with open(os.path.join(corpus, "Transcripts",
                           "Recording_001.json")) as f:
        words = json.load(f)
    out["transcript"] = str(root / "t.json")
    with open(out["transcript"], "w") as f:
        json.dump(words, f)
    return out


def _jax_models(files):
    from gesture2vec_tpu.train import checkpoints

    dae, dae_v, _ = checkpoints.load_checkpoint_and_model(files["dae"],
                                                          "DAE")
    seq, seq_v, _ = checkpoints.load_checkpoint_and_model(files["vq"],
                                                          "autoencoder_vq")
    return dae, dae_v, seq, seq_v


def _port_models(files):
    return (load_checkpoint_and_model(files["dae"], "DAE", "cpu")[0],
            load_checkpoint_and_model(files["vq"], "autoencoder_vq",
                                      "cpu")[0])


@pytest.fixture(scope="module")
def data(files):
    dae, seq = _port_models(files)
    return build_latent_dataset(ClipStore(files["train"]), dae_model=dae,
                                seq_model=seq, n_poses=NP, stride=STRIDE)


def test_decode_codebook_matches_jax(files):
    from gesture2vec_tpu.cluster.latent_dataset import \
        decode_codebook as jax_decode

    got = decode_codebook(*reversed(_port_models(files)))
    dae, dae_v, seq, seq_v = _jax_models(files)
    want = jax_decode(seq, seq_v, dae, dae_v)
    assert got.shape == (K, NP, DIM)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def _compare_bvh_dirs(got_dir, want_dir):
    """Every exported BVH: the same files, the same headers, the motion
    within MOTION_TOL; prints the differing values."""
    rel = lambda d: sorted(os.path.relpath(os.path.join(r, f), d)  # noqa
                           for r, _, fs in os.walk(d) for f in fs)
    names = rel(want_dir)
    assert rel(got_dir) == names and names
    flips, worst = 0, 0.0
    for n in names:
        (h, m), (wh, wm) = (_split(open(os.path.join(d, n)).read())
                            for d in (got_dir, want_dir))
        assert h == wh and m.shape == wm.shape
        flips += int((m != wm).sum())
        worst = max(worst, float(np.abs(m - wm).max()))
    print(f"{len(names)} BVH files: {flips} motion values differ, by at "
          f"most {worst}")
    assert worst <= MOTION_TOL
    return names


def test_export_cluster_samples_matches_jax(files, data, tmp_path):
    from gesture2vec_tpu.cluster.latent_dataset import \
        export_cluster_samples as jax_export
    from gesture2vec_tpu.mocap.features import \
        FeatureExtractor as JaxExtractor

    store = ClipStore(files["train"])
    dae, _ = _port_models(files)
    n = export_cluster_samples(data, str(tmp_path / "port"),
                               FeatureExtractor.load(files["pipeline"]),
                               store.pose_mean, store.pose_std, dae,
                               max_per_token=2)
    j_dae, j_dae_v, _, _ = _jax_models(files)
    want = jax_export(data, str(tmp_path / "jax"),
                      JaxExtractor.load(files["pipeline"]), store.pose_mean,
                      store.pose_std, j_dae, j_dae_v, max_per_token=2)
    assert n == want == sum(min(2, int((data["tokens"] == t).sum()))
                            for t in np.unique(data["tokens"]))
    _compare_bvh_dirs(str(tmp_path / "port"), str(tmp_path / "jax"))


@pytest.mark.parametrize("algo", ["mapdp", "dbscan", "agglomerative"])
def test_cluster_cli_matches_jax_cli(files, algo, monkeypatch):
    """The port's CLI against JAX's: the labels .npy identical; with
    mapdp also --plots (PNGs > 1 kB) and --export-samples 1 (the same
    BVH files)."""
    from gesture2vec_tpu.cli import cluster as jax_cli

    outs = {w: str(files["root"] / f"clusters_{algo}_{w}")
            for w in ("jax", "port")}
    common = [files["dae"], files["vq"], "--store", files["train"],
              "--kmeans", "3", "--algo", algo]
    if algo == "mapdp":
        common += ["--plots", "--export-samples", "1", "--pipeline",
                   files["pipeline"]]
    monkeypatch.setattr(sys, "argv", ["cluster", *common, "--out",
                                      outs["jax"], "--jax-cache", "off"])
    jax_cli.main()
    summary = p_cluster.main([*common, "--out", outs["port"], "--device",
                              "cpu"])
    name = f"{algo}_labels.npy"
    got, want = (np.load(os.path.join(outs[w], name))
                 for w in ("port", "jax"))
    np.testing.assert_array_equal(got, want)
    assert summary["clusters"] == len(np.unique(want))
    if algo == "mapdp":
        for png in ("codebook_tsne.png", "latents_tsne.png"):
            assert os.path.getsize(os.path.join(outs["port"], png)) > 1000
        names = _compare_bvh_dirs(os.path.join(outs["port"], "samples"),
                                  os.path.join(outs["jax"], "samples"))
        assert summary["samples"] == len(names)


def test_cluster_cli_flag_checks(files, monkeypatch):
    common = [files["dae"], files["vq"], "--store", files["train"],
              "--device", "cpu"]
    with pytest.raises(SystemExit):
        p_cluster.main(common + ["--export-samples", "2"])
    monkeypatch.setattr(p_plots, "have_matplotlib", lambda: False)
    with pytest.raises(SystemExit):
        p_cluster.main(common + ["--plots"])


def test_mapdp_matches_jax(rng):
    from gesture2vec_tpu.cluster.mapdp import mapdp_nw as jax_mapdp

    from gesture2vec_tpu_torch.cluster.mapdp import mapdp_nw

    x = np.concatenate([rng.normal(size=(30, 3)) + c
                        for c in (0.0, 6.0, -6.0)])
    got, want = mapdp_nw(x, seed=3), jax_mapdp(x, seed=3)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.k == want.k >= 2 and got.objective == want.objective


def test_tsne_and_unity_exports_match_jax(files, tmp_path, rng):
    """tsne_embed, save_unity_latents (a joint t-SNE of 8 kernels and 40
    latents), save_for_unity and save_html_player: identical output."""
    from gesture2vec_tpu.cluster import analysis as j_analysis
    from gesture2vec_tpu.cluster.plots import tsne_embed as j_tsne
    from gesture2vec_tpu.io.bvh import parse_bvh as j_parse
    from gesture2vec_tpu.mocap import fk as j_fk
    from gesture2vec_tpu.mocap.viz import save_html_player as j_html

    from gesture2vec_tpu_torch.mocap import fk as p_fk

    x = rng.normal(size=(40, 12))
    np.testing.assert_array_equal(p_plots.tsne_embed(x, seed=1),
                                  j_tsne(x, seed=1))
    kernels, latents = rng.normal(size=(8, 12)), x
    idx = rng.integers(0, 5, 40)
    texts = {}
    for w, mod in (("port", p_analysis), ("jax", j_analysis)):
        mod.save_unity_latents(kernels, latents, idx, 5,
                               str(tmp_path / f"u_{w}.txt"))
        texts[w] = open(tmp_path / f"u_{w}.txt").read()
    assert texts["port"] == texts["jax"]
    bvh = files["corpus"] + "/Motion/Recording_000.bvh"
    for w, parse, fk, mod, html in (
            ("port", parse_bvh, p_fk, p_analysis, p_viz.save_html_player),
            ("jax", j_parse, j_fk, j_analysis, j_html)):
        data = parse(bvh)
        mod.save_for_unity(fk.forward_kinematics(data),
                           str(tmp_path / f"p_{w}.txt"))
        html(data, str(tmp_path / f"h_{w}.html"), title="clip")
    for stem in ("p", "h"):
        ext = "txt" if stem == "p" else "html"
        assert (tmp_path / f"{stem}_port.{ext}").read_text() == \
            (tmp_path / f"{stem}_jax.{ext}").read_text()


def test_viz_helpers_match_jax(files):
    from gesture2vec_tpu.io.bvh import parse_bvh as j_parse
    from gesture2vec_tpu.mocap import viz as j_viz

    bvh = files["corpus"] + "/Motion/Recording_000.bvh"
    data, jdata = parse_bvh(bvh), j_parse(bvh)
    for got, want in zip(p_viz.stickfigure_segments(data, 7),
                         j_viz.stickfigure_segments(jdata, 7)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    foot = next(n for n in data.skeleton if "Foot" in n)
    np.testing.assert_array_equal(p_viz.foot_contact_idxs(data, foot),
                                  j_viz.foot_contact_idxs(jdata, foot))


def test_plots_write_pngs(files, tmp_path, rng):
    """Every figure of cluster/plots, cluster/analysis and mocap/viz is
    written and holds more than 1 kB."""
    import matplotlib.pyplot as plt

    fe = FeatureExtractor.load(files["pipeline"])
    p_plots.plot_codebook_tsne(rng.normal(size=(12, 6)),
                               str(tmp_path / "cb.png"),
                               usage=np.arange(12))
    p_plots.plot_latent_space(rng.normal(size=(30, 6)),
                              str(tmp_path / "lat.png"),
                              labels=rng.integers(0, 3, 30))
    p_plots.plot_attention(rng.random((4, 7)), str(tmp_path / "att.png"),
                           words=list("abcdefg"))
    p_viz.plot_loss_curves({"train_loss": [3.0, 2.0, 1.5],
                            "val_loss": [3.2, 2.5, 2.0]},
                           str(tmp_path / "loss.png"))
    data = parse_bvh(files["corpus"] + "/Motion/Recording_000.bvh")
    for i, draw in enumerate((p_viz.draw_stickfigure,
                              p_viz.draw_stickfigure3d)):
        ax = draw(data, 3)
        ax.figure.savefig(str(tmp_path / f"stick{i}.png"))
        plt.close(ax.figure)
    store = ClipStore(files["train"])
    kernel = rng.normal(size=(DIM, 2))
    written = p_analysis.plot_kernel_stickfigures(
        kernel, fe, store.pose_mean, store.pose_std, str(tmp_path / "k"))
    pngs = [str(tmp_path / n) for n in ("cb.png", "lat.png", "att.png",
                                        "loss.png", "stick0.png",
                                        "stick1.png")] + written
    assert len(written) == 5
    assert all(os.path.getsize(p) > 1000 for p in pngs)


def test_silhouette_matches_sklearn(rng):
    from sklearn.metrics import silhouette_score

    for n, d, k in ((40, 3, 2), (120, 16, 7), (60, 400, 11)):
        x = rng.normal(size=(n, d)).astype(np.float32)
        labels = rng.integers(0, k, n)
        labels[0] = k          # a cluster of one point scores 0
        got = p_analysis.silhouette_score(torch.from_numpy(x),
                                          torch.from_numpy(labels))
        assert abs(got - silhouette_score(x, labels)) <= 1e-6
    with pytest.raises(ValueError):
        p_analysis.silhouette_score(torch.from_numpy(x),
                                    torch.zeros(n, dtype=torch.long))


def test_silhouette_sweep_matches_jax_from_same_centers(monkeypatch, rng):
    """Both sweeps seeded with the JAX package's k-means++ centers (its
    three inits per K): the same K-Means fits, so the same scores."""
    from gesture2vec_tpu.cluster import analysis as j_analysis
    from gesture2vec_tpu.cluster import kmeans as j_km

    x = np.concatenate([rng.normal(size=(25, 6)) + c
                        for c in (0.0, 4.0, -4.0)]).astype(np.float32)
    ks = range(2, 6)
    centers = {k: [np.asarray(j_km._plusplus_init(key, jnp.asarray(x), k))
                   for key in jax.random.split(jax.random.PRNGKey(0), 3)]
               for k in ks}

    def seeded(xt, k, generator):
        return torch.from_numpy(centers[k].pop(0))

    monkeypatch.setattr(p_km, "plusplus_init", seeded)
    got = p_analysis.silhouette_sweep(x, ks, device="cpu")
    want = j_analysis.silhouette_sweep(x, ks)
    assert got.keys() == want.keys() == set(ks)
    for k in ks:
        assert abs(got[k] - want[k]) <= 1e-6


def test_bleu_and_load_kmeans_match_jax(tmp_path, rng):
    from gesture2vec_tpu.cluster import kmeans as j_km
    from gesture2vec_tpu.cluster import metrics as j_metrics

    cands = [list(rng.integers(0, 6, n)) for n in (3, 8, 12, 1)]
    refs = [list(rng.integers(0, 6, n)) for n in (5, 8, 10, 4)]
    for c, r in zip(cands, refs):
        assert p_metrics.sentence_bleu(c, r) == j_metrics.sentence_bleu(c, r)
    assert p_metrics.corpus_bleu(cands, refs) == \
        j_metrics.corpus_bleu(cands, refs)
    assert p_metrics.sentence_bleu(refs[1], refs[1]) == 1.0
    res = p_km.kmeans_fit(rng.normal(size=(40, 3)), 3, n_init=1,
                          device="cpu")
    p_km.save_kmeans(str(tmp_path / "km.npz"), res)
    np.testing.assert_array_equal(p_km.load_kmeans(str(tmp_path / "km.npz")),
                                  j_km.load_kmeans(str(tmp_path / "km.npz")))


def test_train_plot_every_writes_codebook_tsne_and_loss_curves(files,
                                                                tmp_path,
                                                                monkeypatch):
    from gesture2vec_tpu_torch.cli import train as p_train

    cfg = {**_seq_cfg(), "epochs": 2, "batch_size": 8,
           "train_data_path": files["train"],
           "val_data_path": files["val"], "model_save_path":
           str(tmp_path / "out")}
    path = tmp_path / "b.yml"
    path.write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))
    argv = ["-c", str(path), "--part", "b", "--rep-checkpoint",
            files["dae"], "--device", "cpu", "--plot-every", "1"]
    p_train.main(argv)
    for png in ("codebook_tsne_ep001.png", "codebook_tsne_ep002.png",
                "loss_curves.png"):
        assert os.path.getsize(tmp_path / "out" / png) > 1000
    monkeypatch.setattr(p_plots, "have_matplotlib", lambda: False)
    with pytest.raises(SystemExit):
        p_train.main(argv)


def test_infer_plot_attention_matches_jax(files, tmp_path, monkeypatch):
    """g2v-infer --plot-attention: the heatmap's matrix and labels are
    those of JAX's command (the first window through the Part d's eval
    forward), and the PNG is written."""
    from gesture2vec_tpu.text.vocab import Vocab as JaxVocab
    from gesture2vec_tpu.train import checkpoints

    from gesture2vec_tpu_torch.cli import infer as p_infer
    from gesture2vec_tpu_torch.io.subtitles import read_subtitles

    shown = {}
    draw = p_plots.plot_attention

    def keep(attn, path, words=None, title="attention"):
        shown.update(attn=attn, words=words)
        draw(attn, path, words=words, title=title)

    monkeypatch.setattr(p_plots, "plot_attention", keep)
    png = str(tmp_path / "attn.png")
    p_infer.main([files["t2t"], files["transcript"], files["dae"],
                  files["vq"], "--store", files["train"], "--pipeline",
                  files["pipeline"], "--mode", "decode", "--device", "cpu",
                  "--out", str(tmp_path / "g.bvh"), "--plot-attention", png])
    assert os.path.getsize(png) > 1000
    model, variables, payload = checkpoints.load_checkpoint_and_model(
        files["t2t"], "text2embedding")
    vocab = JaxVocab.from_state_dict(payload["lang_model"])
    words = [w[0] for w in read_subtitles(files["transcript"])][:48]
    wid = vocab.words_to_ids(words)[:48]
    ids = np.zeros((1, 48), np.int32)
    ids[0, :len(wid)] = wid
    res = jax.jit(lambda a, n: model.apply(
        variables, a, n, jnp.zeros((1, model.n_steps), jnp.int32),
        train=False))(jnp.asarray(ids), jnp.asarray([len(wid)], np.int32))
    want = np.asarray(res["attentions"])[:, 0, :len(wid)]
    np.testing.assert_allclose(shown["attn"], want, atol=ATOL)
    assert shown["words"] == [vocab.index2word.get(int(i), "?")
                              for i in wid]


def test_parity_tokenizer_generation_matches_jax(files, tmp_path,
                                                 monkeypatch):
    """Decode-mode generation over a parity tokenizer (the eval step
    dropout in its chunk rollout, fault C.3 of the reconstruction tests):
    `build_generator` chooses the plain rollout itself from the decoder's
    kernel_reason (fault C.5) and gives the JAX generator's tokens and
    frames when both packages' dropout read one numpy mask stream; a
    caller who asks for the kernel (use_fused_decoder=True) is refused."""
    from gesture2vec_tpu.cli._common import build_generator as jax_build
    from gesture2vec_tpu.data.store import ClipStore as JaxStore
    from gesture2vec_tpu.train import checkpoints
    from gesture2vec_tpu.train.config import load_config

    from gesture2vec_tpu_torch.cli._common import build_generator
    from gesture2vec_tpu_torch.compat.checkpoint import load_checkpoint
    from gesture2vec_tpu_torch.io.subtitles import read_subtitles
    from tests.test_torch_port_reconstruct import _shared_masks

    payload = load_checkpoint(files["vq"])
    parity = str(tmp_path / "vq_parity.bin")
    checkpoints.save_checkpoint(
        parity, config=load_config(_seq_cfg()), epoch=1,
        params=payload["params"],
        pose_dim=REP, extra={**payload["extra"], "parity": True},
        kind="autoencoder_vq")
    args = (files["t2t"], files["dae"], parity)
    with pytest.raises(ValueError, match="eval step dropout"):
        build_generator(*args, ClipStore(files["train"]), mode="decode",
                        device="cpu", use_fused_decoder=True)
    words = read_subtitles(files["transcript"])
    jax_s, port_s = _shared_masks(monkeypatch, 5)
    jgen, _ = jax_build(*args, JaxStore(files["train"]), mode="decode")
    want = jgen.generate(words, 6.0)
    gen, _ = build_generator(*args, ClipStore(files["train"]),
                             mode="decode", device="cpu")
    assert not gen.use_fused_decoder
    got = gen.generate(words, 6.0)
    assert jax_s.draws == port_s.draws > 0
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0,
                               atol=ATOL)


def test_exemplar_mode_over_attention_tokenizer_runs(files, data, tmp_path):
    """Exemplar mode (the generation CLIs' default) over an
    `autoencoder_att` tokenizer: `build_generator` chooses the plain
    rollout from the decoder's kernel_reason (fault C.5: it raised
    before) and a 6 s transcript gives finite frames."""
    from gesture2vec_tpu.train import checkpoints
    from gesture2vec_tpu.train.config import load_config

    from gesture2vec_tpu_torch.cli._common import build_generator
    from gesture2vec_tpu_torch.cluster.latent_dataset import \
        save_latent_dataset
    from gesture2vec_tpu_torch.io.subtitles import read_subtitles
    from gesture2vec_tpu_torch.train.config import load_config as p_config
    from gesture2vec_tpu_torch.train.seq_ae_trainer import make_seq_ae

    cfg = {**_seq_cfg(), "autoencoder_att": True}
    tree = _init_variables(make_seq_ae(p_config(cfg)), 4)
    att = str(tmp_path / "vq_att.bin")
    checkpoints.save_checkpoint(
        att, config=load_config(cfg), epoch=1, params=tree["params"],
        pose_dim=REP, extra={"batch_stats": tree["batch_stats"],
                             "parity": False}, kind="autoencoder_vq")
    bank = str(tmp_path / "bank.npz")
    save_latent_dataset(bank, data)
    gen, _ = build_generator(files["t2t"], files["dae"], att,
                             ClipStore(files["train"]), mode="exemplar",
                             latent_bank_path=bank, device="cpu")
    assert not gen.use_fused_decoder
    frames, tokens = gen.generate(read_subtitles(files["transcript"]), 6.0)
    assert frames.shape == (120, DIM) and np.isfinite(frames).all()
    assert tokens.shape == (12,)
