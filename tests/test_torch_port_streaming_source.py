"""PyTorch port vs the JAX package: the streaming window and frame
sources and the prefetcher (ROADMAP queue A item 3.8).

- `data/streaming.StreamingWindows` and `StreamingFrames` over one store
  (written by the JAX package's writer, read by each package's
  ClipStore) yield JAX's batches bit for bit, for several seeds, epochs,
  strides and reservoir sizes, the transform path included.
- `train_dae` from StreamingFrames and `train_seq_ae` from
  StreamingWindows (with a transform) give JAX's loss history within 1e-5
  relative from JAX's initial weights (the port's trainer starts from
  them), every dropout off on both sides (flax Dropout patched to the
  identity; the port's trainers given no dropout generator).
- The frozen-DAE transform (`data/teacher.window_teacher`) in the prefetch
  worker: the latents the direct encode gives, dropout off in the worker
  while the training thread's generator is set, launches counted under
  the lock.
- `utils/prefetch`: order and device placement, a worker's exception
  raised in the consumer, the worker released when the consumer stops
  early, `place=` refused naming its queue item.
- The refusals JAX makes: `vq_tricks` and `use_similarity` with a stream.
"""
import threading
import time

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from gesture2vec_tpu.data.store import ClipStore as JStore
from gesture2vec_tpu.data.store import ClipStoreWriter
from gesture2vec_tpu.data.streaming import StreamingFrames as JFrames
from gesture2vec_tpu.data.streaming import StreamingWindows as JWindows
from gesture2vec_tpu.train.config import load_config as jax_load_config
from gesture2vec_tpu_torch.data.store import ClipStore
from gesture2vec_tpu_torch.data.streaming import (StreamingFrames,
                                                  StreamingWindows)
from gesture2vec_tpu_torch.models import layers
from gesture2vec_tpu_torch.train import dae_trainer as pdae
from gesture2vec_tpu_torch.train import seq_ae_trainer as pseq
from gesture2vec_tpu_torch.train.config import load_config
from gesture2vec_tpu_torch.utils.prefetch import prefetch

D = 12


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """5 clips of different lengths (one shorter than a window), with
    pose statistics."""
    root = str(tmp_path_factory.mktemp("stream") / "store")
    rng = np.random.default_rng(0)
    w = ClipStoreWriter(root)
    for i, n in enumerate((64, 97, 5, 120, 33)):
        w.add_clip(f"c{i}", rng.normal(size=(n, D)).astype(np.float32))
    w.set_stats(rng.normal(size=D) * 0.1, rng.uniform(0.5, 2.0, D))
    w.finish()
    return root


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout off on both sides: flax's patched to the identity, the
    port's trainers given no generator."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    for mod in (pdae, pseq):
        monkeypatch.setattr(mod, "dropout_generator",
                            lambda gen: layers.dropout_generator(None))


def _lin(batch):
    """A deterministic numpy transform, the same on both sides."""
    return (np.tanh(batch[..., :6]) * 0.5 + 0.1).astype(np.float32)


@pytest.mark.parametrize("seed, epoch, stride, rows, bs, transform", [
    (0, 0, 4, 16, 5, False), (3, 2, 1, 64, 8, False),
    (1, 5, 3, 7, 4, True)])
def test_windows_match_jax_bit_for_bit(store_root, seed, epoch, stride,
                                       rows, bs, transform):
    kw = dict(shuffle_rows=rows, seed=seed,
              transform=_lin if transform else None)
    got = list(StreamingWindows(ClipStore(store_root), 8, stride,
                                **kw).batches(epoch, bs))
    src = JWindows(JStore(store_root), 8, stride, **kw)
    want = [np.asarray(b) for b in src.batches(epoch, bs)]
    assert len(StreamingWindows(ClipStore(store_root), 8, stride)) \
        == len(src)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed, epoch, rows, bs", [
    (0, 0, 64, 16), (2, 3, 10, 7)])
def test_frames_match_jax_bit_for_bit(store_root, seed, epoch, rows, bs):
    got = list(StreamingFrames(ClipStore(store_root), shuffle_rows=rows,
                               seed=seed).batches(epoch, bs))
    src = JFrames(JStore(store_root), shuffle_rows=rows, seed=seed)
    want = list(src.batches(epoch, bs))
    assert len(StreamingFrames(ClipStore(store_root))) == len(src)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _start_from_jax(monkeypatch, mod, jmake, jinit, jcfg):
    """The port trainer's init_model gives JAX's initial weights (the
    JAX trainer's init_state from PRNGKey(seed))."""
    from gesture2vec_tpu.train.optim import make_optimizer

    from gesture2vec_tpu_torch.compat.from_jax import load_jax_variables
    state = jinit(jcfg, jmake(jcfg), jax.random.PRNGKey(
        max(jcfg.random_seed, 0)), make_optimizer(jcfg.learning_rate))
    np_tree = jax.tree_util.tree_map(np.asarray, state)

    def init_model(model, seed, device):
        load_jax_variables(model, np_tree.params, np_tree.batch_stats)
        return model.to(device)
    monkeypatch.setattr(mod, "init_model", init_model)


def _rel_close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=0)


def test_train_dae_from_stream_matches_jax(store_root, no_dropout,
                                           monkeypatch):
    from gesture2vec_tpu.data.datasets import all_frames
    from gesture2vec_tpu.train import dae_trainer as jdae
    from gesture2vec_tpu.train.dae_trainer import train_dae as jtrain
    raw = dict(name="sdae", model="DAE", hidden_size=6, input_motion_dim=D,
               epochs=3, batch_size=32, learning_rate=0.01, random_seed=0)
    _start_from_jax(monkeypatch, pdae, jdae.make_frame_model,
                    jdae.init_state, jax_load_config(raw))
    val = all_frames(JStore(store_root))[:64]
    _, jhist = jtrain(jax_load_config(raw),
                      JFrames(JStore(store_root), shuffle_rows=50, seed=0),
                      val)
    _, hist = pdae.train_dae(load_config(raw),
                             StreamingFrames(ClipStore(store_root),
                                             shuffle_rows=50, seed=0),
                             val, device="cpu")
    _rel_close(hist["train_loss"], jhist["train_loss"])
    _rel_close(hist["val_loss"], jhist["val_loss"])
    assert hist["train_loss"][-1] < hist["train_loss"][0]


def test_train_seq_ae_from_stream_matches_jax(store_root, no_dropout,
                                              monkeypatch):
    from gesture2vec_tpu.data.datasets import pose_windows
    from gesture2vec_tpu.train import seq_ae_trainer as jseq
    from gesture2vec_tpu.train.seq_ae_trainer import train_seq_ae as jtrain
    # lr 5e-4: at 5e-3 Adam's normalised steps turn the fp32 rounding of
    # near-zero gradients into lr-sized moves, and the two packages' runs
    # part by ~1e-3 by the third epoch, streamed or not
    raw = dict(name="svq", model="seq2seq", hidden_size=12, n_layers=2,
               dropout_prob=0.1, epochs=3, batch_size=8,
               learning_rate=0.0005, rep_learning_dim=6, n_poses=8,
               n_pre_poses=1, autoencoder_vq=True,
               autoencoder_vq_components=8, random_seed=0)
    _start_from_jax(monkeypatch, pseq, jseq.make_seq_ae, jseq.init_state,
                    jax_load_config(raw))
    val = _lin(pose_windows(JStore(store_root), 8, 4)[:16])
    _, jhist = jtrain(jax_load_config(raw),
                      JWindows(JStore(store_root), 8, 4, shuffle_rows=32,
                               seed=0, transform=_lin), val)
    _, hist = pseq.train_seq_ae(
        load_config(raw), StreamingWindows(ClipStore(store_root), 8, 4,
                                           shuffle_rows=32, seed=0,
                                           transform=_lin),
        val, device="cpu")
    for k in ("train_loss", "perplexity"):
        _rel_close(hist[k], jhist[k])
    # validation within 1e-3: pre_linear's bias gets a gradient of pure
    # rounding (the batch-statistics BatchNorm cancels it), which Adam
    # turns into lr-sized steps of either sign; the running mean follows
    # that bias with momentum 0.99, so the eval-mode outputs of the two
    # packages part by ~1e-4 relative, streamed or not
    _rel_close(hist["val_loss"], jhist["val_loss"], 1e-3)
    assert hist["train_loss"][-1] < hist["train_loss"][0]


def test_dae_transform_in_the_worker(store_root):
    """The frozen-DAE transform runs in the prefetch worker: its latents
    are the direct encode's, dropout stays off there although the
    training thread holds a generator, and a count taken in the worker
    (the launch counters' lock) adds up with the main thread's."""
    from gesture2vec_tpu_torch.compat.from_jax import flax_init
    from gesture2vec_tpu_torch.data.teacher import (encode_windows_with_dae,
                                                    window_teacher)
    from gesture2vec_tpu_torch.models.dae import DAE
    from gesture2vec_tpu_torch.ops.build import count_launch

    dae = DAE(D, 6)
    flax_init(dae, torch.Generator().manual_seed(0))
    teacher = window_teacher(dae.eval())
    calls, kept = [], []

    def spy():
        pass
    spy.launches = 0

    def transform(batch):
        calls.append(threading.current_thread().name)
        # train-mode dropout at rate 0.9 is the identity in the worker
        kept.append(bool((layers.dropout(torch.ones(64), 0.9, True)
                          == 1).all()))
        for _ in range(100):
            count_launch(spy)
        return teacher(batch)

    src = StreamingWindows(ClipStore(store_root), 8, 4, shuffle_rows=16,
                           seed=1, transform=transform)
    plain = StreamingWindows(ClipStore(store_root), 8, 4, shuffle_rows=16,
                             seed=1)
    with layers.dropout_generator(torch.Generator().manual_seed(1)):
        # the training thread's dropout draws from its generator
        assert not (layers.dropout(torch.ones(64), 0.9, True) == 1).all()
        got = [b for b in prefetch(src.batches(0, 4), "cpu")]
        for _ in range(100 * len(got)):
            count_launch(spy)
    want = [encode_windows_with_dae(dae.eval(), b)
            for b in plain.batches(0, 4)]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and not g.requires_grad
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)
    assert spy.launches == 200 * len(got)
    assert all(kept) and len(kept) == len(got)
    assert all(name != threading.main_thread().name for name in calls)


def test_prefetch_keeps_order_and_places_batches():
    batches = [np.full((2, 3), i, np.float32) for i in range(5)] + \
        [np.arange(4, dtype=np.int32)]
    got = list(prefetch(iter(batches), "cpu"))
    assert [float(b[0, 0]) for b in got[:5]] == [0, 1, 2, 3, 4]
    assert got[5].dtype == torch.int64
    assert all(isinstance(b, torch.Tensor) for b in got)
    # tuples of arrays and tensors keep their structure
    pair = next(prefetch(iter([(batches[5], torch.ones(2))]), "cpu"))
    assert isinstance(pair, tuple) and pair[0].dtype == torch.int64
    # place (the mesh placement, once refused) takes each host batch in
    # place of the default copy
    placed = list(prefetch(iter(batches[:5]), "cpu",
                           place=lambda b: torch.from_numpy(b[:1] * 2)))
    assert [tuple(b.shape) for b in placed] == [(1, 3)] * 5
    assert [float(b[0, 0]) for b in placed] == [0, 2, 4, 6, 8]


def test_prefetch_raises_the_workers_exception():
    def gen():
        yield np.zeros(2, np.float32)
        raise KeyError("clip 7 is missing")
    it = prefetch(gen(), "cpu")
    next(it)
    with pytest.raises(KeyError, match="clip 7"):
        next(it)


def test_prefetch_releases_its_worker_when_the_consumer_stops():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield np.full(3, i, np.float32)
    before = threading.active_count()
    it = prefetch(gen(), "cpu", depth=2)
    assert float(next(it)[0]) == 0
    it.close()  # the consumer stops early
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    assert len(produced) < 10


def test_stream_refusals_follow_jax(store_root):
    src = StreamingWindows(ClipStore(store_root), 8, 4)
    frames = StreamingFrames(ClipStore(store_root))
    with pytest.raises(ValueError, match="vq_tricks needs the in-RAM"):
        pdae.train_dae(load_config(dict(name="x", model="DAE",
                                        hidden_size=6, input_motion_dim=D,
                                        autoencoder_vq=True)),
                       frames, np.zeros((8, D), np.float32), vq_tricks=True,
                       device="cpu")
    with pytest.raises(ValueError, match="use_similarity needs the in-RAM"):
        pseq.train_seq_ae(load_config(dict(
            name="x", hidden_size=12, n_layers=2, rep_learning_dim=D,
            n_poses=8, use_similarity=True)), src,
            np.zeros((8, 8, D), np.float32), device="cpu")


def test_stream_trains_without_the_rvq_refit(store_root, monkeypatch):
    """A residual-VQ tokenizer from a stream skips the K-Means re-fit (it
    sweeps the array), as in JAX."""
    called = []
    monkeypatch.setattr(pseq, "reestimate_rvq_codebooks",
                        lambda *a, **k: called.append(1))
    raw = dict(name="r", hidden_size=12, n_layers=2, rep_learning_dim=6,
               n_poses=8, n_pre_poses=1, autoencoder_vq=True,
               autoencoder_vq_variant="rvq", rvq_stages=2,
               autoencoder_vq_components=8, rvq_reestimate_every=1,
               epochs=2, batch_size=8, random_seed=0)
    src = StreamingWindows(ClipStore(store_root), 8, 4, shuffle_rows=16,
                           seed=0, transform=_lin)
    val = np.zeros((8, 8, 6), np.float32)
    _, hist = pseq.train_seq_ae(load_config(raw), src, val, device="cpu")
    assert not called and np.isfinite(hist["train_loss"]).all()
