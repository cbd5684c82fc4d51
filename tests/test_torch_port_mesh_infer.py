"""PyTorch port vs the JAX package: the row-wise sweeps over a mesh.

The port's counterparts of tests/test_mesh_training.py's teacher-sweep
test and tests/test_e2e.py's generate_batch over dp=4: the corpus sweeps
(`data/teacher`, 37 windows, not a multiple of the mesh's size, so the
pad-and-trim path runs) and `GestureGenerator.generate_batch(mesh=)` (3
transcripts padded to 4 over dp=4), each in a plain process (the rows
run whole) and over 4 gloo ranks (each rank its chunk, then a gather;
one launch for the file), held against the unsharded call and the JAX
package's meshed call from the same weights: token ids identical,
latents within 1e-6 (frames within 1e-5, generate's tolerance). Also
the mesh's checks: too few cards, the `--mesh` flag's reader and the
prefetch placement. `g2v-infer --mesh dp=2 --device cpu` is held against
JAX's in tests/test_torch_port_cli.py, beside its checkpoint files.
"""
import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.compat.from_jax import to_jax_variables
from gesture2vec_tpu_torch.data.teacher import (encode_windows_with_dae,
                                                tokenize_windows)
from gesture2vec_tpu_torch.parallel import launch
from gesture2vec_tpu_torch.parallel.mesh import make_mesh
from gesture2vec_tpu_torch.train.config import load_config
from gesture2vec_tpu_torch.train.dae_trainer import (init_model,
                                                     make_frame_model)
from gesture2vec_tpu_torch.train.seq_ae_trainer import make_seq_ae
from tests.test_torch_port_generate import _port, _words, jax_gen  # noqa
from tests.torch_mesh_ranks import generate_on_ranks, sweep_on_ranks

LAT_TOL, FRAME_TOL = 1e-6, 1e-5
DAE_CFG = dict(name="sp_dae", model="DAE", hidden_size=6, epochs=1,
               batch_size=8, learning_rate=1e-3, input_motion_dim=12,
               random_seed=0)
SQ_CFG = dict(name="sp_sq", model="seq2seq", hidden_size=10, n_layers=2,
              dropout_prob=0.0, epochs=1, batch_size=8, learning_rate=1e-3,
              rep_learning_dim=6, n_poses=4, n_pre_poses=1,
              autoencoder_vq=True, autoencoder_vq_components=12,
              autoencoder_att=False, autoencoder_conditioned=True,
              random_seed=0)
DURATIONS = [4.0, 2.0, 2.0]


def _models():
    cpu = torch.device("cpu")
    dae = init_model(make_frame_model(load_config(DAE_CFG)), 0, cpu).eval()
    seq = init_model(make_seq_ae(load_config(SQ_CFG)), 1, cpu).eval()
    return dae, seq


def _windows():
    return np.random.default_rng(0).normal(size=(37, 4, 12)).astype(
        np.float32)


def _transcripts():
    return [_words(d, seed=i) for i, d in enumerate(DURATIONS)]


@pytest.fixture(scope="module")
def ranked(jax_gen):  # noqa: F811
    """Rank 0's sweeps over sp=4 and generate_batch over dp=4."""
    dae, seq = _models()
    calls = [(sweep_on_ranks, (dae, seq, _windows(), {"sp": 4}), {}),
             (generate_on_ranks, (_port(jax_gen), _transcripts(),
                                  DURATIONS, {"dp": 4}), {})]
    return launch.run(launch.call_all, (calls,), world_size=4,
                      device="cpu")


def _single_sweep():
    dae, seq = _models()
    lat = encode_windows_with_dae(dae, _windows(), batch=16)
    return (lat, *tokenize_windows(seq, lat, batch=16))


def test_teacher_sweeps_on_mesh_match_single_device():
    """A plain process's sp=4 mesh: the single sweep's tokens and latents,
    and the JAX package's sweeps over its sp=8 mesh from the same
    weights."""
    import jax.numpy as jnp

    from gesture2vec_tpu.data.teacher import \
        encode_windows_with_dae as jenc
    from gesture2vec_tpu.data.teacher import tokenize_windows as jtok
    from gesture2vec_tpu.parallel.mesh import make_mesh as jmesh
    from gesture2vec_tpu.train.config import load_config as jload
    from gesture2vec_tpu.train.dae_trainer import \
        make_frame_model as jframe
    from gesture2vec_tpu.train.seq_ae_trainer import make_seq_ae as jseq

    dae, seq = _models()
    mesh = make_mesh({"sp": 4}, "cpu")
    lat0, tok0, sl0 = _single_sweep()
    lat1 = encode_windows_with_dae(dae, _windows(), batch=16, mesh=mesh)
    np.testing.assert_allclose(lat1, lat0, rtol=LAT_TOL, atol=LAT_TOL)
    tok1, sl1 = tokenize_windows(seq, lat0, batch=16, mesh=mesh)
    np.testing.assert_array_equal(tok1, tok0)
    np.testing.assert_allclose(sl1, sl0, rtol=1e-5, atol=LAT_TOL)

    tree = lambda v: {k: {**v[k]} for k in v}  # noqa: E731
    jm = jmesh({"sp": 8})
    dv, sv = tree(to_jax_variables(dae)), tree(to_jax_variables(seq))
    jlat = jenc(jframe(jload(DAE_CFG)), {"params": dv["params"]},
                _windows(), batch=16, mesh=jm)
    np.testing.assert_allclose(lat1, np.asarray(jlat), rtol=LAT_TOL,
                               atol=LAT_TOL)
    jt, jsl = jtok(jseq(jload(SQ_CFG)), sv, jnp.asarray(lat0), batch=16,
                   mesh=jm)
    np.testing.assert_array_equal(tok1, np.asarray(jt))
    np.testing.assert_allclose(sl1, np.asarray(jsl), rtol=1e-5,
                               atol=LAT_TOL)


def test_teacher_sweeps_over_ranks_match_single_device(ranked):
    """4 gloo ranks, each sweeping its chunk of every superbatch: the
    single sweep's tokens and latents."""
    lat, tok, sl = ranked[0]
    lat0, tok0, sl0 = _single_sweep()
    assert lat.shape == lat0.shape and tok.shape == (37,)
    np.testing.assert_allclose(lat, lat0, rtol=LAT_TOL, atol=LAT_TOL)
    np.testing.assert_array_equal(tok, tok0)
    np.testing.assert_allclose(sl, sl0, rtol=1e-5, atol=LAT_TOL)


def _same(got, want):
    assert len(got) == len(want)
    for (f, t), (wf, wt) in zip(got, want):
        np.testing.assert_array_equal(t, wt)
        np.testing.assert_allclose(f, wf, atol=FRAME_TOL)


def test_generate_batch_over_dp_pads_and_matches(jax_gen):  # noqa: F811
    """3 transcripts over a plain process's dp=4 mesh: the unsharded
    call's tokens and frames, and the JAX generator's generate_batch over
    its dp=4 mesh (padded to 4; over ranks the port pads too:
    test_generate_batch_over_ranks)."""
    from gesture2vec_tpu.parallel.mesh import make_mesh as jmesh

    gen = _port(jax_gen)
    want = gen.generate_batch(_transcripts(), DURATIONS)
    _same(gen.generate_batch(_transcripts(), DURATIONS,
                             mesh=make_mesh({"dp": 4}, "cpu")), want)
    _same(want, jax_gen.generate_batch(_transcripts(), DURATIONS,
                                       mesh=jmesh({"dp": 4})))


def test_generate_batch_over_ranks(ranked, jax_gen):  # noqa: F811
    """4 gloo ranks, each generating its transcript (one of them the
    padding): the unsharded call's tokens and frames."""
    _same(ranked[1], _port(jax_gen).generate_batch(_transcripts(),
                                                    DURATIONS))


def test_plain_mesh_runs_the_rows_whole(caplog):
    """A plain process's mesh (no ranks) splits nothing: map_rows runs fn
    once on all the rows, whatever their count, and says so once a mesh;
    the sweeps round their batch to no multiple."""
    mesh = make_mesh({"dp": 4}, "cpu")
    assert mesh.row_split() == mesh.row_split("dp") == 1
    seen = []

    def fn(x, y):
        seen.append((x.shape[0], y.shape[0]))
        return x * 2, y + 1

    x, y = torch.arange(6.0).reshape(6, 1), torch.arange(6)
    with caplog.at_level("INFO"):
        for _ in range(2):
            a, b = mesh.map_rows(fn, [x, y], "dp")
    assert seen == [(6, 6), (6, 6)]
    assert torch.equal(a, x * 2) and torch.equal(b, y + 1)
    said = [r.getMessage() for r in caplog.records
            if "in one process" in r.getMessage()]
    assert len(said) == 1 and "rows run whole" in said[0]


def test_generate_batch_over_a_plain_mesh_runs_once(jax_gen):  # noqa: F811
    """generate_batch over a plain process's dp=4 mesh decodes the 3
    transcripts as one batch of 3 (no padding row), as without a mesh."""
    gen = _port(jax_gen)
    batches = []
    predict = gen._predict_windows

    def recording(word_ids, *a, **k):
        batches.append(word_ids.shape[0])
        return predict(word_ids, *a, **k)

    gen._predict_windows = recording
    got = gen.generate_batch(_transcripts(), DURATIONS,
                             mesh=make_mesh({"dp": 4}, "cpu"))
    assert batches == [3]
    _same(got, _port(jax_gen).generate_batch(_transcripts(), DURATIONS))


def test_make_mesh_needs_the_cards(monkeypatch):
    """A mesh larger than the cards raises ValueError (one card, dp=2),
    as the JAX package's make_mesh does; on the CPU the positions are
    processes, and no mesh_shape is no mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh({"dp": 2}, "cuda")
    assert make_mesh({"dp": 1}, "cuda").devices == [torch.device("cuda",
                                                                 0)]
    mesh = make_mesh({"dp": 2, "tp": 3}, "cpu")
    assert (mesh.size, mesh.axis_size("tp"), mesh.distributed) == (6, 3,
                                                                   False)
    assert make_mesh(None) is None and make_mesh({}) is None


def test_parse_mesh_flag():
    """--mesh 'dp=4,tp=2' as the JAX package's parse_mesh reads it."""
    from gesture2vec_tpu_torch.cli._common import (parse_mesh,
                                                   parse_mesh_shape)

    assert parse_mesh_shape("dp=4,tp=2") == {"dp": 4, "tp": 2}
    assert parse_mesh_shape(None) is None and parse_mesh(None) is None
    assert parse_mesh("dp=2", "cpu").shape == {"dp": 2}


def test_prefetch_places_rows_with_the_mesh():
    """prefetch(place=batch_placer(mesh)): the batches arrive as the
    placer gives them (a plain process's mesh keeps the global batch)."""
    from gesture2vec_tpu_torch.parallel.mesh import batch_placer
    from gesture2vec_tpu_torch.utils.prefetch import prefetch

    batches = [np.full((4, 2), i, np.float32) for i in range(3)]
    got = list(prefetch(iter(batches), "cpu",
                        place=batch_placer(make_mesh({"dp": 2}, "cpu"))))
    assert [t.shape for t in got] == [(4, 2)] * 3
    assert [float(t[0, 0]) for t in got] == [0.0, 1.0, 2.0]
