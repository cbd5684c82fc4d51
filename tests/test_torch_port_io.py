"""PyTorch port vs the JAX package: the host-side motion stack that the
port's `g2v-infer` and `make_dataset` run (BVH reader and writer,
transcripts, rotations, forward kinematics, the motion pipeline and its
`data_pipe.json`, feature extraction, export smoothing, audio).

Both packages are numpy here, so the same inputs give the same bits:
every comparison is exact (byte-identical text, `assert_array_equal`),
except audio (1e-6). Where the JAX package may take its native C++
helpers (float parsing, the "%.6f" grid, ZXY euler -> matrix), the tests
run it both ways or pin it to its numpy path, as each case says.
"""
import json

import numpy as np
import pytest
from scipy.io import wavfile

import gesture2vec_tpu.utils.native as jax_native
from gesture2vec_tpu.infer import exporter as j_exporter
from gesture2vec_tpu.infer import smoothing as j_smoothing
from gesture2vec_tpu.io import audio as j_audio
from gesture2vec_tpu.io import bvh as j_bvh
from gesture2vec_tpu.io import subtitles as j_subtitles
from gesture2vec_tpu.mocap import features as j_features
from gesture2vec_tpu.mocap import fk as j_fk
from gesture2vec_tpu.mocap import pipeline as j_pipeline
from gesture2vec_tpu.mocap import rotations as j_rot
from gesture2vec_tpu_torch.infer import exporter as p_exporter
from gesture2vec_tpu_torch.infer import smoothing as p_smoothing
from gesture2vec_tpu_torch.io import audio as p_audio
from gesture2vec_tpu_torch.io import bvh as p_bvh
from gesture2vec_tpu_torch.io import subtitles as p_subtitles
from gesture2vec_tpu_torch.mocap import features as p_features
from gesture2vec_tpu_torch.mocap import fk as p_fk
from gesture2vec_tpu_torch.mocap import pipeline as p_pipeline
from gesture2vec_tpu_torch.mocap import rotations as p_rot
from tests.fixtures import make_synthetic_bvh, make_synthetic_twh_bvh

ORDERS = ("XYZ", "XZY", "YXZ", "YZX", "ZXY", "ZYX")
# values whose "%.6f" text is easy to get wrong: signed zeros, values
# that round to a signed zero, and decimal half-way points
AWKWARD = np.array([0.0, -0.0, 1e-7, -1e-7, -4e-7, 0.0000005, -0.0000005,
                    0.5, 2.5e-6, 123456.4999995, -99.9999995, 1.0000005,
                    -1.0000015, 1e6 + 0.0000005, 359.9999996])


@pytest.fixture()
def numpy_only(monkeypatch):
    """The JAX package on its numpy path: its native helpers report
    themselves unavailable."""
    monkeypatch.setattr(jax_native, "load", lambda: None)


def _texts():
    return {"trinity": make_synthetic_bvh(n_frames=90, fps=60, seed=3),
            "twh": make_synthetic_twh_bvh(n_frames=90, fps=30, seed=4)}


def _same_bvh(got, want):
    assert got.root_name == want.root_name
    assert got.frame_time == want.frame_time
    assert got.channel_names == want.channel_names
    assert list(got.skeleton) == list(want.skeleton)
    for name, j in want.skeleton.items():
        g = got.skeleton[name]
        assert (g.parent, g.channels, g.order, g.children) == \
            (j.parent, j.channels, j.order, j.children)
        np.testing.assert_array_equal(g.offsets, j.offsets)
    assert got.values.dtype == want.values.dtype
    np.testing.assert_array_equal(got.values, want.values)


# -- BVH reader and writer ---------------------------------------------
@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind", ["trinity", "twh", "truncated"])
def test_parse_bvh_matches_jax(kind, native, tmp_path, monkeypatch):
    """From a file and from text; a truncated motion block keeps its
    whole frames on both sides."""
    if not native:
        monkeypatch.setattr(jax_native, "load", lambda: None)
    text = _texts()["trinity" if kind == "truncated" else kind]
    if kind == "truncated":
        text = text[: len(text) - 700]
    path = tmp_path / "clip.bvh"
    path.write_text(text)
    for args in ((str(path),), (text, True)):
        _same_bvh(p_bvh.parse_bvh(*args), j_bvh.parse_bvh(*args))
    _same_bvh(p_bvh.parse_bvh(text, True, dtype=np.float32),
              j_bvh.parse_bvh(text, True, dtype=np.float32))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind", ["trinity", "twh"])
def test_write_bvh_is_byte_identical(kind, native, tmp_path, monkeypatch):
    """The same text as the JAX writer (its native "%.6f" grid and its
    Python one), signed zeros and half-way values included; a given
    frame rate and an empty motion block too."""
    if not native:
        monkeypatch.setattr(jax_native, "load", lambda: None)
    data = p_bvh.parse_bvh(_texts()[kind], from_text=True)
    rng = np.random.default_rng(0)
    n = data.values.shape[1]
    awkward = np.resize(AWKWARD, (4, n)) * rng.choice([1, -1], (4, n))
    data.values = np.concatenate([data.values, awkward, -awkward])
    jdata = j_bvh.parse_bvh(_texts()[kind], from_text=True)
    jdata.values = data.values
    for kw in ({}, {"framerate": 24.0}):
        assert p_bvh.write_bvh(data, **kw) == j_bvh.write_bvh(jdata, **kw)
    p_bvh.write_bvh(data, str(tmp_path / "p" / "a.bvh"))
    j_bvh.write_bvh(jdata, str(tmp_path / "j" / "a.bvh"))
    assert (tmp_path / "p" / "a.bvh").read_bytes() == \
        (tmp_path / "j" / "a.bvh").read_bytes()
    data.values, jdata.values = data.values[:0], jdata.values[:0]
    assert p_bvh.write_bvh(data) == j_bvh.write_bvh(jdata)


def test_format_motion_is_pythons_format():
    rng = np.random.default_rng(1)
    mat = np.concatenate([rng.normal(scale=100.0, size=(20, 15)),
                          AWKWARD[None], -AWKWARD[None]])
    assert p_bvh.format_motion(mat) == "\n".join(
        " ".join(f"{v:.6f}" for v in row) for row in mat) + "\n"


# -- transcripts --------------------------------------------------------
_WORDS = [("Hello,", "0.100s", "0.400s"), ("shouldn't", "0.5s", "0.9s"),
          ("--", "1.0s", "1.1s"), ("100", 1.2, 1.5),
          ("Well!", "1.6s", "2.0s")]


@pytest.mark.parametrize("layout", ["stt_results", "stt_flat", "tsv"])
def test_subtitles_match_jax(layout, tmp_path):
    if layout == "stt_results":
        path = tmp_path / "t.json"
        path.write_text(json.dumps({"results": [
            {"alternatives": [{"words": [
                {"word": w, "startTime": s, "endTime": e}
                for w, s, e in _WORDS[:3]]}]},
            {"alternatives": [{"transcript": "x"}]},
            {"alternatives": [{"words": [
                {"word": w, "startTime": s, "endTime": e}
                for w, s, e in _WORDS[3:]]}]}]}))
    elif layout == "stt_flat":
        path = tmp_path / "t.json"
        path.write_text(json.dumps([{"word": w, "start_time": s,
                                     "end_time": e} for w, s, e in _WORDS]))
    else:
        path = tmp_path / "t.tsv"
        path.write_text("".join(
            f"{float(str(s).rstrip('s'))}\t{float(str(e).rstrip('s'))}\t{w}\n"
            for w, s, e in _WORDS) + "short line\n")
    got = p_subtitles.read_subtitles(str(path))
    assert got == j_subtitles.read_subtitles(str(path))
    assert [w for w, _, _ in got] == ["hello ,", "shouldnt", "100", "well !"]


# -- rotations and forward kinematics -----------------------------------
@pytest.mark.parametrize("order", ORDERS)
def test_rotations_match_jax(order):
    """euler <-> matrix <-> rotvec <-> quat, with gimbal-locked and tiny
    rotations among the inputs."""
    rng = np.random.default_rng(2)
    euler = rng.uniform(-180, 180, size=(4, 50, 3))
    euler[0, :5, 1] = [90.0, -90.0, 89.99999, -90.00001, 0.0]
    mats = p_rot.euler_to_matrix(euler, order)
    np.testing.assert_array_equal(mats, j_rot.euler_to_matrix(euler, order))
    np.testing.assert_array_equal(p_rot.matrix_to_euler(mats, order),
                                  j_rot.matrix_to_euler(mats, order))
    rotvec = rng.normal(size=(60, 3))
    rotvec[:3] = [[0.0, 0.0, 0.0], [1e-8, 0.0, -1e-7], [np.pi, 0.0, 0.0]]
    for p_fn, j_fn, x in (
            (p_rot.rotvec_to_matrix, j_rot.rotvec_to_matrix, rotvec),
            (p_rot.matrix_to_quat, j_rot.matrix_to_quat, mats),
            (p_rot.matrix_to_rotvec, j_rot.matrix_to_rotvec, mats),
            (p_rot.unroll_rotvec, j_rot.unroll_rotvec,
             np.cumsum(rotvec, axis=0))):
        np.testing.assert_array_equal(p_fn(x), j_fn(x))
    np.testing.assert_array_equal(p_rot.euler_to_rotvec(euler, order),
                                  j_rot.euler_to_rotvec(euler, order))
    np.testing.assert_array_equal(p_rot.rotvec_to_euler(rotvec, order),
                                  j_rot.rotvec_to_euler(rotvec, order))


@pytest.mark.parametrize("kind", ["trinity", "twh"])
def test_forward_kinematics_matches_jax(kind):
    text = _texts()[kind]
    pd, jd = p_bvh.parse_bvh(text, True), j_bvh.parse_bvh(text, True)
    got, want = p_fk.forward_kinematics(pd), j_fk.forward_kinematics(jd)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    values = pd.values[::2] * 0.5
    np.testing.assert_array_equal(p_fk.positions_matrix(pd, values),
                                  j_fk.positions_matrix(jd, values))


# -- feature extraction ---------------------------------------------------
def test_feature_extractor_matches_jax(numpy_only):
    """process (features and mirror), transform and the to_bvh inverse,
    with the JAX side's ZXY conversion on its numpy path."""
    text = make_synthetic_bvh(n_frames=240, fps=60, seed=5)
    pf, jf = p_features.FeatureExtractor(), j_features.FeatureExtractor()
    got = pf.process(p_bvh.parse_bvh(text, True))
    want = jf.process(j_bvh.parse_bvh(text, True))
    assert got[0].shape == (80, 135)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert pf.orders == jf.orders
    other = make_synthetic_bvh(n_frames=120, fps=60, seed=6)
    np.testing.assert_array_equal(pf.transform(p_bvh.parse_bvh(other, True)),
                                  jf.transform(j_bvh.parse_bvh(other, True)))
    feats = got[0] + 0.05 * np.random.default_rng(7).normal(
        size=got[0].shape)
    back_p, back_j = pf.to_bvh(feats), jf.to_bvh(feats)
    np.testing.assert_array_equal(back_p.values, back_j.values)
    assert p_bvh.write_bvh(back_p) == j_bvh.write_bvh(back_j)


def test_euler_to_features_all_zxy_against_jax_native():
    """The port's all-ZXY conversion against the JAX package's default
    (native when it builds): within 1e-12, its own contract."""
    e = np.random.default_rng(8).uniform(-180, 180, size=(30, 15 * 3))
    np.testing.assert_allclose(
        p_features.euler_to_features(e, ["ZXY"] * 15),
        j_features.euler_to_features(e, ["ZXY"] * 15), rtol=0, atol=1e-12)


# -- data_pipe.json interchange -----------------------------------------
PORT, JAX = (p_bvh, p_features), (j_bvh, j_features)


def _fitted(pkg, variant):
    """(extractor, features) of one package, (bvh, features) modules,
    fitted on the same clip."""
    bvh, features = pkg
    if variant == "trinity":
        fe = features.FeatureExtractor()
        text = make_synthetic_bvh(n_frames=180, fps=60, seed=9)
        return fe, fe.process(bvh.parse_bvh(text, True))[0]
    fe = features.TWHFeatureExtractor(variant)
    text = make_synthetic_twh_bvh(n_frames=120, fps=30, seed=10)
    return fe, fe.process(bvh.parse_bvh(text, True))


@pytest.mark.parametrize("variant", ["trinity", "test1", "posrot"])
def test_data_pipe_json_interchange(variant, tmp_path, numpy_only):
    """Each package saves the same data_pipe.json; each loads the other's
    and inverts the same features to the same values and text."""
    (pf, p_feat), (jf, j_feat) = _fitted(PORT, variant), _fitted(JAX, variant)
    np.testing.assert_array_equal(p_feat, j_feat)
    pf.save(str(tmp_path / "p.json"))
    jf.save(str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "j.json").read_text()
    feats = p_feat + 0.02 * np.random.default_rng(11).normal(
        size=p_feat.shape)
    if variant == "trinity":
        loaded_p = p_features.FeatureExtractor.load(str(tmp_path / "j.json"))
        loaded_j = j_features.FeatureExtractor.load(str(tmp_path / "p.json"))
    else:
        loaded_p = p_features.TWHFeatureExtractor.load(
            str(tmp_path / "j.json"), variant)
        loaded_j = j_features.TWHFeatureExtractor.load(
            str(tmp_path / "p.json"), variant)
    want = jf.to_bvh(feats)
    for back in (loaded_p.to_bvh(feats), loaded_j.to_bvh(feats)):
        np.testing.assert_array_equal(back.values, want.values)
        assert j_bvh.write_bvh(back) == j_bvh.write_bvh(want)


def test_to_positions_pipeline_interchange(tmp_path):
    """A pipeline with ToPositions (forward kinematics), saved by either
    package and loaded by the other: the same positions."""
    text = make_synthetic_bvh(n_frames=60, fps=60, seed=12)

    def pipe(m):
        return m.MotionPipeline([("pos", m.ToPositions()),
                                 ("np", m.Numpyfy())])

    pp, jp = pipe(p_pipeline), pipe(j_pipeline)
    got = pp.fit_transform([p_bvh.parse_bvh(text, True)])
    np.testing.assert_array_equal(
        got, jp.fit_transform([j_bvh.parse_bvh(text, True)]))
    pp.save(str(tmp_path / "p.json"))
    jp.save(str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "j.json").read_text()
    other = make_synthetic_bvh(n_frames=60, fps=60, seed=13)
    pd, jd = p_bvh.parse_bvh(other, True), j_bvh.parse_bvh(other, True)
    np.testing.assert_array_equal(
        p_pipeline.MotionPipeline.load(str(tmp_path / "j.json"))
        .transform([pd]),
        j_pipeline.MotionPipeline.load(str(tmp_path / "p.json"))
        .transform([jd]))


# -- export ---------------------------------------------------------------
def test_smoothing_matches_jax():
    x = np.random.default_rng(14).normal(size=(90, 12))
    for p_fn, j_fn, args in (
            (p_smoothing.savgol, j_smoothing.savgol, ()),
            (p_smoothing.savgol, j_smoothing.savgol, (7, 3)),
            (p_smoothing.moving_average, j_smoothing.moving_average, ()),
            (p_smoothing.smoothing_spline, j_smoothing.smoothing_spline, ()),
            (p_smoothing.smoothing_spline, j_smoothing.smoothing_spline,
             (0.9,)),
            (p_smoothing.export_smooth, j_smoothing.export_smooth, ())):
        for y in (x, x[:3], x.astype(np.float32)):
            np.testing.assert_array_equal(p_fn(y, *args), j_fn(y, *args))


@pytest.mark.parametrize("variant", ["trinity", "test1"])
@pytest.mark.parametrize("smooth", [True, False])
def test_frames_to_bvh_is_byte_identical(variant, smooth, tmp_path,
                                         numpy_only):
    (pf, feat), (jf, _) = _fitted(PORT, variant), _fitted(JAX, variant)
    frames = (feat + 0.05 * np.random.default_rng(15).normal(
        size=feat.shape)).astype(np.float32)
    if variant == "trinity":
        p_fn, j_fn = p_exporter.frames_to_bvh, j_exporter.frames_to_bvh
    else:
        p_fn, j_fn = (p_exporter.frames_to_bvh_twh,
                      j_exporter.frames_to_bvh_twh)
    p_fn(frames, pf, path=str(tmp_path / "p.bvh"), smooth=smooth)
    j_fn(frames, jf, path=str(tmp_path / "j.bvh"), smooth=smooth)
    assert (tmp_path / "p.bvh").read_bytes() == \
        (tmp_path / "j.bvh").read_bytes()
    np.testing.assert_array_equal(p_fn(frames, pf, smooth=smooth).values,
                                  j_fn(frames, jf, smooth=smooth).values)


# -- audio ----------------------------------------------------------------
@pytest.mark.parametrize("kind", ["int16_44k_stereo", "float32_16k",
                                  "uint8_8k", "int32_48k"])
def test_audio_matches_jax(kind, tmp_path):
    dtype, sr = {"int16_44k_stereo": (np.int16, 44100),
                 "float32_16k": (np.float32, 16000),
                 "uint8_8k": (np.uint8, 8000),
                 "int32_48k": (np.int32, 48000)}[kind]
    rng = np.random.default_rng(16)
    t = np.arange(int(1.3 * sr)) / sr
    wave = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.normal(size=t.shape)
    if kind.endswith("stereo"):
        wave = np.stack([wave, 0.5 * wave], axis=1)
    if dtype == np.uint8:
        data = (128 + 100 * wave).astype(np.uint8)
    elif dtype == np.float32:
        data = wave.astype(np.float32)
    else:
        data = (wave * 0.5 * np.iinfo(dtype).max).astype(dtype)
    path = str(tmp_path / "a.wav")
    wavfile.write(path, sr, data)
    got, want = p_audio.load_wav(path), j_audio.load_wav(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(p_audio.mel_spectrogram(got),
                               j_audio.mel_spectrogram(want),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        p_audio.mel_spectrogram(got, log=False, n_mels=40),
        j_audio.mel_spectrogram(want, log=False, n_mels=40),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(p_audio.mel_chunks_per_second(got),
                               j_audio.mel_chunks_per_second(want),
                               rtol=0, atol=1e-6)
