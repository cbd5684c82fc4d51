"""PyTorch port vs the JAX package: the two user-facing commands of this
slice, `make_dataset` (BVH corpus -> clip stores and data_pipe.json) and
`g2v-infer` (transcript -> BVH file).

The ingest runs both packages on one synthetic Trinity-layout corpus,
the JAX side's native helpers pinned to numpy, and asks for the same
bits. The inference runs the port's CLI entry function with `--device
cpu` on JAX-written checkpoints (a small-width generator with the 135-wide
pose of the Trinity skeleton), the JAX-ingested store and its
data_pipe.json, against the JAX package's `build_generator`,
`load_bvh_exporter` and `generate` / `generate_batch` in this process:
the same tokens, frames within 1e-5, the same BVH header and frame count.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import gesture2vec_tpu.utils.native as jax_native
from gesture2vec_tpu_torch.cli import infer as p_infer
from gesture2vec_tpu_torch.cli import make_dataset as p_make_dataset
from gesture2vec_tpu_torch.cli._common import load_bvh_exporter
from gesture2vec_tpu_torch.data.store import ClipStore
from gesture2vec_tpu_torch.io.bvh import write_bvh
from tests.corpus import make_corpus
from tests.fixtures import make_synthetic_twh_bvh

ATOL = 1e-5
HID, REP, K, DIM, NF, SENT, FPS, MAXW = 16, 8, 32, 135, 4, 24, 20, 10
N_WORDS, WORDEMBED, VOCAB_WORDS = 60, 12, 40


def _same_store(got_dir, want_dir):
    """Meta (clips, words, statistics, fps, width) and every clip array
    exactly equal, each store read by its own package's reader."""
    from gesture2vec_tpu.data.store import ClipStore as JaxStore

    got, want = ClipStore(got_dir), JaxStore(want_dir)
    assert got.meta == want.meta
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        g, w = got.arrays(i), want.arrays(i)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.fixture(scope="module")
def ingested(tmp_path_factory):
    """One corpus through both packages' ingest: the port's through its
    CLI, JAX's through ingest_trinity on its numpy path."""
    from gesture2vec_tpu.data.ingest import ingest_trinity

    root = tmp_path_factory.mktemp("ingest")
    corpus = make_corpus(str(root / "corpus"), n_files=3, n_frames=360)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "load", lambda: None)
        want = ingest_trinity(corpus, str(root / "jax"))
    got = p_make_dataset.main([corpus, "--out", str(root / "port")])
    return {"root": root, "got": got, "want": want}


def test_make_dataset_matches_jax_ingest(ingested):
    """Trinity: the first file is validation, stores hold float16 poses,
    words and audio, the statistics are over the float16 poses, and
    data_pipe.json is the last clip's fit."""
    root = ingested["root"]
    assert [os.path.relpath(p, root) for p in ingested["got"]] == \
        [os.path.join("port", "train"), os.path.join("port", "val")]
    for got, want in zip(ingested["got"], ingested["want"]):
        _same_store(got, want)
    train = ClipStore(ingested["got"][0])
    assert train.meta["feature_dim"] == DIM and train.meta["fps"] == 20
    assert [c["vid"] for c in train.clips] == [
        "Recording_001", "Recording_001_mirror", "Recording_002",
        "Recording_002_mirror"]
    assert "audio" in train.arrays(0)
    assert (root / "port" / "data_pipe.json").read_text() == \
        (root / "jax" / "data_pipe.json").read_text()


@pytest.mark.parametrize("variant", ["test1", "posrot"])
def test_ingest_twh_matches_jax(variant, tmp_path, monkeypatch):
    from scipy.io import wavfile

    from gesture2vec_tpu.data.ingest import ingest_twh

    monkeypatch.setattr(jax_native, "load", lambda: None)
    for d in ("bvh", "tsv", "wav"):
        (tmp_path / "c" / d).mkdir(parents=True)
    for i in range(2):
        name = f"val_2023_{i:03d}"
        (tmp_path / "c" / "bvh" / f"{name}.bvh").write_text(
            make_synthetic_twh_bvh(n_frames=90, fps=30, seed=i))
        (tmp_path / "c" / "tsv" / f"{name}.tsv").write_text(
            "0.1\t0.4\tHello\n0.5\t0.9\tthere!\n")
        wavfile.write(str(tmp_path / "c" / "wav" / f"{name}.wav"), 16000,
                      np.sin(np.arange(48000) / 30.0).astype(np.float32))
    want = ingest_twh(str(tmp_path / "c"), str(tmp_path / "jax"), variant)
    got = p_make_dataset.main([str(tmp_path / "c"), "--out",
                               str(tmp_path / "port"), "--dataset", "twh",
                               "--twh-variant", variant])
    for g, w in zip(got, want):
        _same_store(g, w)
    assert (tmp_path / "port" / "data_pipe.json").read_text() == \
        (tmp_path / "jax" / "data_pipe.json").read_text()


# -- g2v-infer ---------------------------------------------------------------
def _words(duration_s, seed=0):
    rng = np.random.default_rng(seed)
    starts = np.linspace(0.1, duration_s - 0.5, int(2.5 * duration_s))
    return [[f"word{rng.integers(VOCAB_WORDS + 10)}", float(s),
             float(s + 0.3)] for s in starts]


@pytest.fixture(scope="module")
def files(ingested):
    """JAX-written checkpoints of a small-width generator at the
    Trinity pose width, a latent bank, the JAX-ingested train store and
    data_pipe.json, and two Google-STT transcripts (one in each layout)."""
    from bench import build_generator as bench_generator
    from gesture2vec_tpu.text.vocab import Vocab as JaxVocab
    from gesture2vec_tpu.train import checkpoints
    from gesture2vec_tpu.train.config import load_config

    from gesture2vec_tpu_torch.cluster.latent_dataset import \
        save_latent_dataset

    g = bench_generator(hid=HID, rep=REP, k=K, dim=DIM, n_frames=NF,
                        sent_len=SENT, n_words=N_WORDS, max_words=MAXW,
                        wordembed=WORDEMBED, vocab_words=VOCAB_WORDS,
                        fps=FPS, mode="exemplar", bank_windows=300)
    rng = np.random.default_rng(7)

    def perturb(tree):
        def leaf(path, x):
            x = np.asarray(x)
            noise = rng.normal(size=x.shape).astype(np.float32) * 0.3
            if getattr(path[-1], "key", None) == "var":
                return (np.abs(x + noise) + 0.5).astype(np.float32)
            return (x + noise).astype(np.float32)
        return jax.tree_util.tree_map_with_path(leaf, tree)

    root = ingested["root"]
    vocab = JaxVocab("bench")
    for i in range(VOCAB_WORDS):
        vocab.index_word(f"word{i}")
    common = dict(model="seq2seq", hidden_size=HID, n_layers=2,
                  dropout_prob=0.2, epochs=1, batch_size=8, n_poses=NF,
                  autoencoder_vq=True, autoencoder_vq_components=K,
                  random_seed=0)
    out = {"store": ingested["want"][0],
           "pipeline": str(root / "jax" / "data_pipe.json"),
           "bank": str(root / "bank.npz"), "t2t": str(root / "t2t.bin"),
           "dae": str(root / "dae.bin"), "vq": str(root / "vq.bin")}
    save_latent_dataset(out["bank"], g.latent_bank)
    t2t_vars = perturb(g.t2t_variables)
    checkpoints.save_checkpoint(
        out["t2t"], config=load_config(dict(
            name="t", sentence_frame_length=SENT, n_pre_poses=2,
            autoencoder_att=True, wordembed_dim=WORDEMBED,
            motion_resampling_framerate=FPS, **common)),
        epoch=1, params=t2t_vars["params"], lang_model=vocab.state_dict(),
        extra={"batch_stats": t2t_vars["batch_stats"], "n_words": N_WORDS},
        kind="text2embedding")
    checkpoints.save_checkpoint(
        out["dae"], config=load_config(dict(
            name="d", model="DAE", hidden_size=REP, input_motion_dim=DIM,
            random_seed=0)), epoch=1,
        params=perturb(g.dae_variables)["params"], pose_dim=DIM, kind="DAE")
    seq_vars = perturb(g.seq_variables)
    checkpoints.save_checkpoint(
        out["vq"], config=load_config(dict(
            name="s", rep_learning_dim=REP, n_pre_poses=1, **common)),
        epoch=1, params=seq_vars["params"], pose_dim=REP,
        extra={"batch_stats": seq_vars["batch_stats"], "parity": False},
        kind="autoencoder_vq")
    (root / "a.json").write_text(json.dumps({"results": [{"alternatives": [
        {"words": [{"word": w, "startTime": f"{s}s", "endTime": f"{e}s"}
                   for w, s, e in _words(7.0)]}]}]}))
    (root / "b.json").write_text(json.dumps([
        {"word": w, "start_time": s, "end_time": e}
        for w, s, e in _words(4.0, 1)]))
    out["transcripts"] = [str(root / "a.json"), str(root / "b.json")]
    return out


def _jax_reference(files, transcripts, mode, policy, mesh=None):
    """(frames, tokens, BVH text) per transcript through the JAX
    package's own inference functions (a batch over mesh where given)."""
    from gesture2vec_tpu.cli._common import build_generator as jax_build
    from gesture2vec_tpu.cli._common import \
        load_bvh_exporter as jax_exporter
    from gesture2vec_tpu.data.store import ClipStore as JaxStore
    from gesture2vec_tpu.io.bvh import write_bvh as jax_write_bvh
    from gesture2vec_tpu.io.subtitles import read_subtitles

    gen, _ = jax_build(
        files["t2t"], files["dae"], files["vq"], JaxStore(files["store"]),
        mode=mode, seed=0,
        latent_bank_path=files["bank"] if mode == "exemplar" else None,
        **policy)
    to_bvh = jax_exporter("trinity", files["pipeline"])
    words = [read_subtitles(t) for t in transcripts]
    durs = [w[-1][2] for w in words]
    results = (gen.generate_batch(words, durs, mesh=mesh) if len(words) > 1
               else [gen.generate(words[0], durs[0])])
    return [(np.asarray(f), np.asarray(t),
             jax_write_bvh(to_bvh(np.asarray(f)))) for f, t in results]


def _split(text):
    head, motion = text.split("Frame Time:", 1)
    lines = motion.splitlines()
    return (head + "Frame Time:" + lines[0],
            np.array([ln.split() for ln in lines[1:]], np.float64))


# Motion tolerance, in BVH units (degrees, and the root's position
# channels). The export is exact (the port's exporter on JAX's frames
# gives JAX's text), so the motion differs only through the frames, which
# differ by float32 rounding (2.4e-7 to 3e-7 here). The export computes in
# the frames' dtype, float32: savgol keeps it, the arcsin / arctan2 of the
# euler extraction round to float32 (an ulp of a 100-degree angle is
# ~8e-6), their slopes grow as an untrained model's non-orthonormal
# matrices near a pole, and savgol's edge fit weights the last frames
# several times over. These inputs give at most 5.4e-3 degrees, at the
# last frame; 1e-2 degrees is far below a visible difference (joints move
# about a degree a frame at 20 fps) and far above the rounding noise.
MOTION_TOL = 1e-2


@pytest.mark.parametrize("case", ["decode", "exemplar_continuity",
                                  "decode_two_transcripts",
                                  "exemplar_two_transcripts"])
def test_infer_cli_matches_jax(case, files, tmp_path):
    mode = case.split("_")[0]
    policy = {"exemplar_continuity": True} if "continuity" in case else {}
    transcripts = files["transcripts"][:2 if "two" in case else 1]
    argv = [files["t2t"], *transcripts, files["dae"], files["vq"],
            "--store", files["store"], "--pipeline", files["pipeline"],
            "--mode", mode, "--out", str(tmp_path / "gen.bvh"),
            "--device", "cpu"]
    if mode == "exemplar":
        argv += ["--latent-bank", files["bank"]]
    if policy:
        argv.append("--exemplar-continuity")
    got = p_infer.main(argv)
    want = _jax_reference(files, transcripts, mode, policy)
    if len(transcripts) > 1:
        assert [p for _, _, p in got] == [str(tmp_path / "gen_a.bvh"),
                                          str(tmp_path / "gen_b.bvh")]
    else:
        assert [p for _, _, p in got] == [str(tmp_path / "gen.bvh")]
    to_bvh = load_bvh_exporter("trinity", files["pipeline"])
    for (frames, tokens, path), (w_frames, w_tokens, w_text) in zip(got,
                                                                    want):
        np.testing.assert_array_equal(tokens, w_tokens)
        assert frames.shape == w_frames.shape and frames.shape[1] == DIM
        np.testing.assert_allclose(frames, w_frames, rtol=0, atol=ATOL)
        # the export is exact: the port's exporter on JAX's frames
        assert write_bvh(to_bvh(w_frames)) == w_text
        with open(path) as f:
            head, motion = _split(f.read())
        w_head, w_motion = _split(w_text)
        assert head == w_head
        assert motion.shape == w_motion.shape == (frames.shape[0],
                                                  w_motion.shape[1])
        err = float(np.abs(motion - w_motion).max())
        print(f"{case}: largest BVH motion difference {err}")
        assert err <= MOTION_TOL


@pytest.mark.parametrize("flag", [["--mesh", "dp=2"],
                                  ["--plot-attention", "attn.png"]])
def test_infer_refuses_unported_flags(flag, files, tmp_path):
    """Both flags, once refused, are ported. `g2v-infer --mesh dp=2
    --device cpu` on two transcripts splits the batch over dp: the JAX
    command's tokens (its generate_batch over a dp=2 mesh) and frames
    within ATOL. --plot-attention (tests/test_torch_port_analysis.py)
    passes the option checks and the command fails only at the missing
    files."""
    if flag[0] == "--mesh":
        from gesture2vec_tpu.parallel.mesh import make_mesh

        argv = [files["t2t"], *files["transcripts"], files["dae"],
                files["vq"], "--store", files["store"], "--pipeline",
                files["pipeline"], "--mode", "decode", "--out",
                str(tmp_path / "gen.bvh"), "--device", "cpu", *flag]
        got = p_infer.main(argv)
        want = _jax_reference(files, files["transcripts"], "decode", {},
                              mesh=make_mesh({"dp": 2}))
        assert len(got) == len(want) == 2
        for (frames, tokens, _), (w_frames, w_tokens, _) in zip(got, want):
            np.testing.assert_array_equal(tokens, w_tokens)
            np.testing.assert_allclose(frames, w_frames, rtol=0, atol=ATOL)
        return
    argv = ["t2t.bin", "a.json", "dae.bin", "vq.bin", "--store", "store",
            "--pipeline", "pipe.json", "--device", "cpu", *flag]
    with pytest.raises(FileNotFoundError):
        p_infer.main(argv)


def test_infer_without_card_raises(files, monkeypatch):
    """--device defaults to cuda: without a card the CLI raises, it does
    not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        p_infer.main([files["t2t"], files["transcripts"][0], files["dae"],
                      files["vq"], "--store", files["store"], "--pipeline",
                      files["pipeline"], "--mode", "decode"])


def test_infer_defaults_match_jax():
    """Exemplar mode, the Trinity export and the last word's end as the
    duration by default, as in the JAX CLI; the device is cuda."""
    args = p_infer.build_parser().parse_args(
        ["t", "a.json", "d", "v", "--store", "s", "--pipeline", "p"])
    assert (args.mode, args.dataset, args.twh_variant, args.out,
            args.duration, args.seed, args.temperature, args.top_k,
            args.stage0_temperature, args.beam_width, args.decode_overlap,
            args.soft_decode, args.exemplar_continuity, args.device) == (
        "exemplar", "trinity", "test1", "generated.bvh", None, 0, 0.0, 0,
        -1.0, 0, 0, 0.0, False, "cuda")
