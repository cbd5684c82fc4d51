"""PyTorch port vs the JAX package: `cli/tools` (`python -m
gesture2vec_tpu_torch.cli.tools`).

- `unityfy` and `human_study_clips` write byte-identical files to JAX's
  (JSON transcripts in both Google layouts and a TSV; a synthetic BVH).
- `c2g_samples` over JAX-written c2g and DAE checkpoints (small widths,
  weights from one JAX init), a corpus ingested by `make_dataset` and
  its data_pipe.json: the same files as JAX's, the decoded motion within
  1e-5, identical BVH headers and the BVH motion within 1e-2 degrees
  (the euler extraction of an untrained model's matrices amplifies
  float32 rounding; tests/test_torch_port_cli.py's MOTION_TOL).
- `baseline-infer` through `main(argv)` with `--device cpu` against
  JAX's `baseline_infer` (the body of JAX's command) on a JAX-written
  baseline checkpoint: frames within 1e-5.
- The refused flag `--platform`, and without `--device cpu` the two
  model commands raise on a machine without a card.
- On the card (`gpu`, skipped here): reference payloads written from the
  port's own modules (flax_init from a seed), `import-checkpoint`, then
  `g2v-infer --mode decode` on the card against `--device cpu`. The JAX
  package and the repo's test helpers are imported inside the CPU tests
  only (the card's machine has no flax, and its site-packages shadow
  `tests`).
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.cli import tools

ATOL = 1e-5
MOTION_TOL = 1e-2
REP, HID, NCL, NF = 8, 16, 6, 10


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _repo_tests(name):
    """tests/<name>.py loaded from its file (a `tests` package installed
    in site-packages would shadow the checkout's)."""
    full = f"tests.{name}"
    if full in sys.modules:
        return sys.modules[full]
    spec = importlib.util.spec_from_file_location(
        full, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


def _make_corpus(root, **kw):
    """tests/corpus.make_corpus, loaded by path (it imports
    tests.fixtures, so that is loaded first)."""
    _repo_tests("fixtures")
    return _repo_tests("corpus").make_corpus(root, **kw)


def _files_of(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_unityfy_matches_jax(tmp_path):
    """Both Google-STT layouts and a GENEA TSV: the same files, byte for
    byte, and the default Unity/ directory."""
    from gesture2vec_tpu.cli.tools import unityfy as jax_unityfy

    jdir = tmp_path / "transcripts"
    jdir.mkdir()
    (jdir / "a.json").write_text(json.dumps([
        {"word": "hello", "start_time": "0.10s", "end_time": "0.40s"},
        {"word": "world", "start_time": "0.50s", "end_time": "0.90s"}]))
    (jdir / "b.json").write_text(json.dumps({"results": [{"alternatives": [
        {"words": [{"word": "again", "startTime": "1.25s",
                    "endTime": "1.5s"}]}]}]}))
    (jdir / "c.tsv").write_text("0.1\t0.4\tHello\n0.5\t0.9\tthere!\n")
    got = tools.unityfy(str(jdir), str(tmp_path / "port"))
    want = jax_unityfy(str(jdir), str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["a.txt", "b.txt", "c.txt"]
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()
    assert "0.1,0.4,hello" in open(got[0]).read()
    assert tools.main(["unityfy", str(jdir)]) == [
        str(jdir / "Unity" / f"{n}.txt") for n in "abc"]


def test_human_study_clips_match_jax(tmp_path):
    """A 12 s BVH at 60 fps cut into two 6 s clips with their words: the
    same BVH and word files as JAX's, byte for byte (the CLI too)."""
    from gesture2vec_tpu.cli.tools import human_study_clips as jax_clips

    from gesture2vec_tpu_torch.io.bvh import parse_bvh

    bvh_path = tmp_path / "clip.bvh"
    bvh_path.write_text(_repo_tests("fixtures").make_synthetic_bvh(
        n_frames=720, fps=60))
    tpath = tmp_path / "clip.json"
    tpath.write_text(json.dumps([
        {"word": f"w{i}", "start_time": f"{i}.0s",
         "end_time": f"{i}.4s"} for i in range(12)]))
    got = tools.main(["human-study", str(bvh_path), str(tpath), "--out",
                      str(tmp_path / "port")])
    want = jax_clips(str(bvh_path), str(tpath), str(tmp_path / "jax"),
                     clip_seconds=6.0)
    assert len(got) == len(want) == 2
    assert _files_of(tmp_path / "port") == _files_of(tmp_path / "jax")
    for name in _files_of(tmp_path / "jax"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert parse_bvh(got[0]).n_frames == 360
    assert open(got[0].replace(".bvh", ".txt")).read().split()


# -- the model commands over JAX-written checkpoints ---------------------------
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 2-file corpus through the port's make_dataset; JAX-written DAE,
    c2g and baseline checkpoints (weights from JAX inits, perturbed) at
    the corpus' pose width; the first transcript."""
    import jax
    import jax.numpy as jnp

    from gesture2vec_tpu.models.dae import DAE
    from gesture2vec_tpu.train import checkpoints as jckpt
    from gesture2vec_tpu.train import misc_trainers as jmisc
    from gesture2vec_tpu.train.config import load_config

    from gesture2vec_tpu_torch.cli import make_dataset
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.text.vocab import build_vocab
    from tests.test_torch_port_models import perturb

    root = tmp_path_factory.mktemp("tools")
    base = _make_corpus(str(root / "corpus"), n_files=2, n_frames=240,
                        with_audio=False)
    train, _ = make_dataset.main([base, "--out", str(root / "store"),
                                  "--no-audio"])
    store = ClipStore(train)
    dim = store.pose_mean.shape[0]
    n_words = build_vocab("corpus", [[w[0] for w in c["words"]]
                                     for c in store.clips]).n_words
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(0)
    common = dict(model="seq2seq", hidden_size=HID, n_layers=2,
                  dropout_prob=0.1, epochs=1, batch_size=8, n_poses=NF,
                  n_pre_poses=2, wordembed_dim=12, random_seed=0,
                  motion_resampling_framerate=20)
    files = {"root": root, "store": train,
             "pipeline": str(root / "store" / "data_pipe.json"),
             "transcript": os.path.join(base, "Transcripts",
                                        "Recording_000.json"),
             "dim": dim}
    dae = DAE(motion_dim=dim, latent_dim=REP)
    v = perturb(jax.tree_util.tree_map(np.asarray, dae.init(
        key, jnp.zeros((2, dim)))), rng)
    files["dae"] = str(root / "dae.bin")
    jckpt.save_checkpoint(files["dae"], config=load_config(dict(
        name="d", model="DAE", hidden_size=REP, input_motion_dim=dim)),
        epoch=1, params=v["params"], pose_dim=dim, kind="DAE")
    c2g_cfg = load_config(dict(name="c", autoencoder_vq_components=NCL,
                               **{**common, "n_layers": 1}))
    c2g = jmisc.make_c2g(c2g_cfg, REP)
    v = perturb(jax.tree_util.tree_map(np.asarray, c2g.init(
        key, jnp.zeros((2,), jnp.int32))), rng)
    files["c2g"] = str(root / "c2g.bin")
    jckpt.save_checkpoint(files["c2g"], config=c2g_cfg, epoch=1,
                          params=v["params"], pose_dim=REP,
                          extra={"batch_stats": v["batch_stats"]},
                          kind="c2g")
    base_cfg = load_config(dict(name="b", **common))
    baseline = jmisc.make_baseline(base_cfg, n_words, dim)
    v = perturb(jax.tree_util.tree_map(np.asarray, baseline.init(
        key, jnp.zeros((1, 8), jnp.int32), jnp.ones((1,), jnp.int32),
        jnp.zeros((1, NF, dim)))), rng, 0.1)
    files["baseline"] = str(root / "baseline.bin")
    jckpt.save_checkpoint(files["baseline"], config=base_cfg, epoch=1,
                          params=v["params"], pose_dim=dim,
                          extra={"batch_stats": v["batch_stats"],
                                 "n_words": n_words}, kind="baseline")
    return files


def _recording(monkeypatch, module):
    """Every frames_to_bvh call's frames, the real export still run."""
    seen = []
    real = module.frames_to_bvh

    def record(frames, fe, path=None):
        seen.append(np.array(frames))
        return real(frames, fe, path=path)
    monkeypatch.setattr(module, "frames_to_bvh", record)
    return seen


def _same_bvh(got_path, want_path):
    got, want = open(got_path).read(), open(want_path).read()
    head, motion = got.split("Frame Time:", 1)
    w_head, w_motion = want.split("Frame Time:", 1)
    assert head == w_head
    m = np.array([ln.split() for ln in motion.splitlines()[1:]], float)
    w = np.array([ln.split() for ln in w_motion.splitlines()[1:]], float)
    assert m.shape == w.shape and m.shape[0] > 0
    assert float(np.abs(m - w).max()) <= MOTION_TOL


def test_c2g_samples_match_jax(corpus, monkeypatch):
    """One rollout over every (cluster, sample) id and one DAE decode:
    the same sample files as JAX's, motion within 1e-5."""
    import gesture2vec_tpu.infer.exporter as jexp
    from gesture2vec_tpu.cli.tools import c2g_samples as jax_c2g_samples

    import gesture2vec_tpu_torch.infer.exporter as pexp

    root = corpus["root"]
    got_frames = _recording(monkeypatch, pexp)
    want_frames = _recording(monkeypatch, jexp)
    n = tools.main(["c2g-samples", corpus["c2g"], corpus["dae"], "--store",
                    corpus["store"], "--pipeline", corpus["pipeline"],
                    "--out", str(root / "c2g_port"), "--clusters",
                    str(NCL), "--per-cluster", "2", "--device", "cpu"])
    want = jax_c2g_samples(corpus["c2g"], corpus["dae"], corpus["store"],
                           corpus["pipeline"], str(root / "c2g_jax"),
                           NCL, 2)
    assert n == want == 2 * NCL
    assert _files_of(root / "c2g_port") == _files_of(root / "c2g_jax")
    assert len(got_frames) == len(want_frames) == n
    for g, w in zip(got_frames, want_frames):
        assert g.shape == w.shape == (NF, corpus["dim"])
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    for name in _files_of(root / "c2g_jax"):
        _same_bvh(root / "c2g_port" / name, root / "c2g_jax" / name)


def test_baseline_infer_matches_jax(corpus, monkeypatch):
    """`baseline-infer --device cpu` through main against JAX's
    baseline_infer on the same checkpoint, store, pipeline and
    transcript: frames within 1e-5, the same BVH header."""
    import gesture2vec_tpu.infer.exporter as jexp
    from gesture2vec_tpu.cli.tools import baseline_infer as jax_baseline

    root = corpus["root"]
    want_frames = _recording(monkeypatch, jexp)
    got = tools.main(["baseline-infer", corpus["baseline"],
                      corpus["transcript"], "--store", corpus["store"],
                      "--pipeline", corpus["pipeline"], "--out",
                      str(root / "base_port.bvh"), "--device", "cpu"])
    jax_baseline(corpus["baseline"], corpus["transcript"], corpus["store"],
                 corpus["pipeline"], str(root / "base_jax.bvh"))
    assert len(want_frames) == 1
    assert got.shape == want_frames[0].shape and got.shape[0] > NF
    np.testing.assert_allclose(got, want_frames[0], rtol=0, atol=ATOL)
    _same_bvh(root / "base_port.bvh", root / "base_jax.bvh")


def test_tools_refuse_platform_and_need_a_card(corpus, monkeypatch):
    """JAX's --platform is refused (argparse exits 2); --device defaults
    to cuda, so without a card both model commands raise rather than
    fall back to the CPU."""
    root = corpus["root"]
    base = ["baseline-infer", corpus["baseline"], corpus["transcript"],
            "--store", corpus["store"], "--pipeline", corpus["pipeline"],
            "--out", str(root / "x.bvh")]
    c2g = ["c2g-samples", corpus["c2g"], corpus["dae"], "--store",
           corpus["store"], "--pipeline", corpus["pipeline"], "--out",
           str(root / "x"), "--clusters", "2"]
    with pytest.raises(SystemExit) as e:
        tools.main(base + ["--platform", "cpu"])
    assert e.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (base, c2g):
        with pytest.raises(RuntimeError, match="CUDA device"):
            tools.main(argv)
    assert not os.path.exists(root / "x.bvh")


def test_tools_defaults_match_jax():
    """The same subcommands, arguments and defaults as JAX's parser, with
    --device (default cuda) on the two model commands."""
    parser = tools.build_parser()
    args = parser.parse_args(["human-study", "a.bvh", "t.json"])
    assert (args.out, args.seconds) == ("human_study", 6.0)
    args = parser.parse_args(["c2g-samples", "c.bin", "d.bin", "--store",
                              "s", "--pipeline", "p", "--clusters", "3"])
    assert (args.out, args.per_cluster, args.device) == \
        ("c2g_samples", 3, "cuda")
    args = parser.parse_args(["baseline-infer", "b.bin", "t.json",
                              "--store", "s", "--pipeline", "p"])
    assert (args.out, args.duration, args.device) == \
        ("baseline.bvh", None, "cuda")
    args = parser.parse_args(["unityfy", "dir"])
    assert args.out is None
    with pytest.raises(SystemExit):
        parser.parse_args(["import-checkpoint", "a.pt", "b.bin", "--kind",
                           "c2g"])


# -- on the card ---------------------------------------------------------------
@pytest.mark.gpu
def test_imported_decode_on_card_matches_cpu(tmp_path):
    """Reference payloads of a DAE, a GS-Soft tokenizer and a GRU-encoder
    Part d (the port's modules flax_init-ed from a seed, written in the
    reference's layout by tests/torch_reference_layout.py), imported
    with `import-checkpoint`, then `g2v-infer --mode decode` on a 12 s
    transcript on the card against `--device cpu`: tokens identical,
    frames within 1e-4 of the largest magnitude, one chunk-decoder
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from gesture2vec_tpu_torch.cli import infer, make_dataset
    from gesture2vec_tpu_torch.compat import from_jax as fj
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.ops import decoder_kernel as dk
    from gesture2vec_tpu_torch.text.vocab import build_vocab
    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.train.seq_ae_trainer import make_seq_ae
    from gesture2vec_tpu_torch.train.text2token_trainer import \
        make_text2token

    R = _repo_tests("torch_reference_layout")
    base = _make_corpus(str(tmp_path / "corpus"), n_files=2, n_frames=480,
                        with_audio=False)
    train, _ = make_dataset.main([base, "--out", str(tmp_path / "store"),
                                  "--no-audio"])
    store = ClipStore(train)
    dim = store.pose_mean.shape[0]
    n_words = build_vocab("corpus", [[w[0] for w in c["words"]]
                                     for c in store.clips]).n_words
    common = dict(model="seq2seq", hidden_size=32, n_layers=2, n_poses=NF,
                  autoencoder_vq=True, autoencoder_vq_components=16,
                  rep_learning_dim=REP)
    cfgs = {"DAE": dict(name="d", model="DAE", hidden_size=REP,
                        input_motion_dim=dim),
            "autoencoder_vq": dict(name="s", n_pre_poses=1, **common),
            "text2embedding": dict(name="t", n_pre_poses=2,
                                   sentence_frame_length=6 * NF,
                                   wordembed_dim=24, text_encoder="gru",
                                   autoencoder_att=True,
                                   motion_resampling_framerate=20,
                                   **common)}
    gen = torch.Generator().manual_seed(0)
    models = {"DAE": DAE(dim, REP),
              "autoencoder_vq": make_seq_ae(load_config(
                  cfgs["autoencoder_vq"])),
              "text2embedding": make_text2token(load_config(
                  cfgs["text2embedding"]), n_words)}
    paths = {}
    for kind, model in models.items():
        fj.flax_init(model, gen)
        v = fj.to_jax_variables(model)
        sd = {"DAE": lambda: R.dae_sd(v["params"]),
              "autoencoder_vq": lambda: R.seq_ae_sd(
                  v["params"], v["batch_stats"], 2),
              "text2embedding": lambda: R.text2token_sd(
                  v["params"], v["batch_stats"], 2)}[kind]()
        pt = str(tmp_path / f"{kind}.pt")
        torch.save(R.reference_payload(sd, R.reference_args(cfgs[kind]),
                                       pose_dim=dim), pt)
        paths[kind] = str(tmp_path / f"{kind}.bin")
        tools.main(["import-checkpoint", pt, paths[kind], "--kind", kind])
    vocab_words = [w[0] for w in store.clips[0]["words"]]
    words = [[vocab_words[i % len(vocab_words)], 0.25 * i + 0.1,
              0.25 * i + 0.3] for i in range(46)]
    transcript = tmp_path / "t.json"
    transcript.write_text(json.dumps([
        {"word": w, "start_time": f"{s}s", "end_time": f"{e}s"}
        for w, s, e in words]))
    out = {}
    for dev in ("cuda", "cpu"):
        dk.fused_chunk_decode.launches = 0
        (frames, tokens, _), = infer.main([
            paths["text2embedding"], str(transcript), paths["DAE"],
            paths["autoencoder_vq"], "--store", train, "--pipeline",
            str(tmp_path / "store" / "data_pipe.json"), "--mode", "decode",
            "--out", str(tmp_path / f"{dev}.bvh"), "--device", dev])
        out[dev] = (frames, tokens, dk.fused_chunk_decode.launches)
    (f_card, t_card, n_card), (f_cpu, t_cpu, n_cpu) = out["cuda"], \
        out["cpu"]
    assert (n_card, n_cpu) == (1, 0)
    np.testing.assert_array_equal(t_card, t_cpu)
    assert f_card.shape == f_cpu.shape and f_cpu.shape[1] == dim
    assert np.isfinite(f_card).all()
    err = float(np.abs(f_card - f_cpu).max()) / max(
        float(np.abs(f_cpu).max()), 1.0)
    assert err <= 1e-4, err
