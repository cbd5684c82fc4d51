"""PyTorch port vs the JAX package: msgpack, clip stores, windows and
checkpoint payloads.

The port reads the JAX package's files without msgpack, flax or yaml
(`gesture2vec_tpu_torch/utils/mpack.py`); these tests pin its codec
against the real `msgpack` and `flax.serialization`, and its clip store,
window extraction and checkpoint reader against the JAX package's.
"""
import os

import jax
import msgpack
import numpy as np
import pytest
from flax import serialization

from gesture2vec_tpu_torch.data import datasets as port_ds
from gesture2vec_tpu_torch.data.store import ClipStore, ClipStoreWriter
from gesture2vec_tpu_torch.utils import mpack

DIM = 12

SCALARS = [None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
           2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
           -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 1.5, -0.0,
           float("inf"), 1e300, "", "a" * 31, "b" * 32, "c" * 255,
           "d" * 256, "é" * 40000, "x" * 70000, b"", b"z" * 300,
           b"y" * 70000]
CONTAINERS = [list(range(15)), list(range(16)), list(range(70000)),
              {str(i): i for i in range(15)},
              {str(i): [i, None] for i in range(16)},
              {1: 2, "a": [1, {"b": None, "c": [True, 2.5]}]}]


@pytest.mark.parametrize("obj", SCALARS + CONTAINERS,
                         ids=lambda o: repr(o)[:20])
def test_mpack_matches_msgpack_both_ways(obj):
    ref = msgpack.packb(obj, use_bin_type=True)
    assert mpack.packb(obj) == ref
    assert mpack.unpackb(ref) == msgpack.unpackb(ref, raw=False,
                                                  strict_map_key=False)


def test_mpack_reads_every_width_msgpack_writes():
    """float32 (0xca) and the str16 / ext16 / ext32 headers, which
    packb never emits for these values, still decode."""
    f32 = msgpack.packb([1.25, -3.5], use_single_float=True)
    assert f32[1] == 0xca and mpack.unpackb(f32) == [1.25, -3.5]
    for n in (1, 2, 4, 8, 16, 17, 300, 70000):
        raw = msgpack.packb(msgpack.ExtType(1, mpack.packb(
            [[n], "uint8", bytes(range(256)) * (n // 256) +
             bytes(range(n % 256))])))
        arr = mpack.unpackb(raw)
        assert arr.dtype == np.uint8 and arr.shape == (n,)


def _tree(rng):
    return {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                       "b": np.zeros((0,), np.float64),
                       "i": rng.integers(0, 9, size=(2, 2, 1))},
            "args": {"x": 1.25, "n": None, "l": [1, 2], "s": "abc"},
            "epoch": 3, "count": np.int32(7), "loss": np.float32(2.5),
            "flag": np.bool_(True)}


def _sorted(t):
    return {k: _sorted(t[k]) for k in sorted(t)} if isinstance(t, dict) else t


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


def test_mpack_reads_flax_payloads_and_flax_reads_mpack(rng):
    tree = _tree(rng)
    flax_bytes = serialization.msgpack_serialize(tree)
    _assert_tree_equal(mpack.unpackb(flax_bytes),
                       serialization.msgpack_restore(flax_bytes))
    # flax writes dict keys sorted (its tree_map); given the same order
    # the port writes the same bytes
    assert mpack.packb(_sorted(tree)) == flax_bytes
    _assert_tree_equal(serialization.msgpack_restore(mpack.packb(tree)),
                       tree)


def test_mpack_raises_on_what_it_does_not_read():
    import jax.numpy as jnp

    with pytest.raises(ValueError, match="ext type 5"):
        mpack.unpackb(msgpack.packb(msgpack.ExtType(5, b"abc")))
    with pytest.raises(ValueError, match="ext type 2"):     # flax complex
        mpack.unpackb(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="bfloat16"):
        mpack.unpackb(serialization.msgpack_serialize(
            {"a": np.asarray(jnp.ones(3, jnp.bfloat16))}))
    with pytest.raises(ValueError, match="chunked"):
        mpack.unpackb(mpack.packb({"x": {"__msgpack_chunked_array__": True,
                                         "shape": {"0": 2}}}))
    with pytest.raises(ValueError, match="not a msgpack type"):
        mpack.unpackb(b"\xc1")
    with pytest.raises(ValueError, match="after the msgpack object"):
        mpack.unpackb(b"\x01\x02")
    with pytest.raises(TypeError, match="cannot pack"):
        mpack.packb({"s": {1, 2}})


def _clips(rng, n_clips=3):
    return [(f"vid{i}", rng.normal(size=(30 + 7 * i, DIM)),
             [["hello", 0.1 * i, 0.5], ["world", 0.6, 1.0 + i]],
             rng.normal(size=100 + i).astype(np.float32))
            for i in range(n_clips)]


def _write(writer_cls, root, clips, mean, std):
    w = writer_cls(root)
    for vid, poses, words, audio in clips:
        w.add_clip(vid, poses, words=words, audio=audio,
                   latents=poses[:, :3])
    w.set_stats(mean, std)
    w.set_meta(fps=20, note="synthetic")
    w.finish()


def _assert_stores_equal(a, b):
    assert len(a) == len(b) and a.meta == b.meta
    np.testing.assert_array_equal(a.pose_mean, b.pose_mean)
    np.testing.assert_array_equal(a.pose_std, b.pose_std)
    assert a.pose_mean.dtype == b.pose_mean.dtype == np.float32
    for i in range(len(a)):
        ca, cb = a[i], b[i]
        assert set(ca) == set(cb)
        for k in ca:
            if isinstance(ca[k], np.ndarray):
                assert ca[k].dtype == cb[k].dtype
                np.testing.assert_array_equal(ca[k], cb[k])
            else:
                assert ca[k] == cb[k]
        assert ca["poses"].dtype == np.float32


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_reads_identically_through_both_packages(tmp_path, rng,
                                                       writer):
    from gesture2vec_tpu.data import store as jax_store

    clips = _clips(rng)
    mean = rng.normal(size=DIM)
    std = np.abs(rng.normal(size=DIM))
    cls = {"jax": jax_store.ClipStoreWriter, "port": ClipStoreWriter}
    _write(cls[writer], str(tmp_path), clips, mean, std)
    _assert_stores_equal(ClipStore(str(tmp_path)),
                         jax_store.ClipStore(str(tmp_path)))


def test_store_writers_write_the_same_index(tmp_path, rng):
    from gesture2vec_tpu.data import store as jax_store

    clips = _clips(rng)
    mean, std = rng.normal(size=DIM), np.abs(rng.normal(size=DIM))
    _write(jax_store.ClipStoreWriter, str(tmp_path / "j"), clips, mean, std)
    _write(ClipStoreWriter, str(tmp_path / "p"), clips, mean, std)
    index = [open(tmp_path / d / "meta.msgpack", "rb").read()
             for d in ("j", "p")]
    assert index[0] == index[1]


def test_store_cache_is_bounded_and_read_only(tmp_path, rng):
    _write(ClipStoreWriter, str(tmp_path), _clips(rng, 6),
           np.zeros(DIM), np.ones(DIM))
    store = ClipStore(str(tmp_path))
    for i in range(6):
        store.arrays(i)
    assert list(store._cache) == [2, 3, 4, 5]
    with pytest.raises(ValueError):
        store.arrays(5)["poses"][0, 0] = 1.0


@pytest.mark.parametrize("T,window,stride",
                         [(40, 8, 3), (8, 8, 5), (7, 8, 1), (100, 20, 5),
                          (100, 20, 10), (33, 1, 1)])
def test_extract_windows_matches_native(rng, T, window, stride):
    from gesture2vec_tpu.utils import native

    frames = rng.normal(size=(T, DIM)).astype(np.float32)
    got = port_ds.extract_windows(frames, window, stride)
    want = native.extract_windows(frames, window, stride)
    assert got.shape == want.shape == ((T - window) // stride + 1
                                       if T >= window else 0, window, DIM)
    assert got.dtype == np.float32 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)


def test_pose_windows_and_normalize_match_jax(tmp_path, rng):
    from gesture2vec_tpu.data import datasets as jax_ds
    from gesture2vec_tpu.data import store as jax_store

    mean, std = rng.normal(size=DIM), np.abs(rng.normal(size=DIM))
    std[0] = 1e-4                          # clipped to 0.01 on both sides
    _write(jax_store.ClipStoreWriter, str(tmp_path), _clips(rng),
           mean, std)
    js, ps = jax_store.ClipStore(str(tmp_path)), ClipStore(str(tmp_path))
    for m, s in ((None, None), (mean.astype(np.float32) + 1,
                                std.astype(np.float32) * 2)):
        got = port_ds.pose_windows(ps, 8, 3, m, s)
        want = jax_ds.pose_windows(js, 8, 3, m, s)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    x = rng.normal(size=(5, DIM)).astype(np.float32)
    np.testing.assert_array_equal(port_ds.normalize(x, mean, std),
                                  jax_ds.normalize(x, mean, std))


def test_checkpoint_reader_matches_jax_loader(tmp_path):
    """A checkpoint as the Part-b trainer saves it (params, batch stats,
    optimizer state and PRNG key, parity flag, extras in the config)."""
    from gesture2vec_tpu.train import checkpoints
    from gesture2vec_tpu.train.config import load_config
    from gesture2vec_tpu.train.optim import make_optimizer
    from gesture2vec_tpu.train.seq_ae_trainer import init_state, make_seq_ae

    from gesture2vec_tpu_torch.compat.checkpoint import load_checkpoint

    cfg = load_config(dict(name="vq", model="seq2seq", hidden_size=16,
                           n_layers=2, rep_learning_dim=8, n_poses=8,
                           autoencoder_vq=True, autoencoder_vq_components=32,
                           random_seed=0, seq_arch="bigru", custom_knob=3))
    model = make_seq_ae(cfg)
    key = jax.random.PRNGKey(0)
    st = init_state(cfg, model, key, make_optimizer(1e-3))
    path = str(tmp_path / "vq.bin")
    checkpoints.save_checkpoint(
        path, config=cfg, epoch=4, params=st.params, pose_dim=8,
        extra={"batch_stats": st.batch_stats, "parity": True,
               **checkpoints.resume_extra(st, key, cfg)},
        kind="autoencoder_vq")
    want = checkpoints.load_checkpoint(path)
    got = load_checkpoint(path)
    for k in ("epoch", "pose_dim", "kind", "lang_model"):
        assert got[k] == want[k]
    _assert_tree_equal(got["params"], jax.tree_util.tree_map(
        np.asarray, want["params"]))
    assert got["extra"]["parity"] is True
    assert set(got["extra"]) == set(want["extra"])
    jcfg = want["config"]
    for k, v in got["config"].items():
        ref = jcfg.extras[k] if k in jcfg.extras else getattr(jcfg, k)
        if isinstance(ref, np.ndarray):
            np.testing.assert_array_equal(v, ref)
        else:
            assert v == ref, k
    assert got["config"]["custom_knob"] == 3
    assert os.path.getsize(path) > 0
