"""PyTorch port vs the JAX package: `utils/flops` (the analytic counts,
the card's peaks, `mfu`, `counted_flops`) and `utils/profiling`
(`StageTimer`, `trace`, `annotate`), on the CPU.

- Every analytic count equals JAX's at the benchmark shapes (the goldens
  of tests/test_flops.py) and over a sweep of small shapes.
- `counted_flops` (torch's FlopCounterMode) on the plain CPU forward of
  the DAE, the tokenizer and the Part d at the benchmark widths sits
  within [0.8x, 2.0x] of the analytic count, the band JAX's test holds
  XLA's count to.
- StageTimer as tests/test_audio_ssl_reconstruct.py's case, its report
  in JAX's format, and where it synchronises; `trace()` writes a Chrome
  trace holding an `annotate`d stage.
"""
import itertools
import json
import os

import numpy as np
import pytest
import torch

from gesture2vec_tpu_torch.utils import flops as F
from gesture2vec_tpu_torch.utils import profiling

COUNTS = ("dense_flops", "gru_cell_flops", "gru_flops",
          "dae_forward_flops", "seq_ae_forward_flops",
          "text2token_forward_flops", "transformer_t2t_forward_flops",
          "e2e_decode_flops")


def test_analytic_goldens_at_benchmark_shapes():
    """tests/test_flops.py's goldens (its benchmark shapes and the
    hand-computed transformer count)."""
    assert F.dae_forward_flops(128) == pytest.approx(2_764_800.0)
    assert F.seq_ae_forward_flops(128) == pytest.approx(8_822_937_600.0)
    assert F.text2token_forward_flops(128, max_words=32, n_steps=4) \
        == pytest.approx(6_274_816_000.0)
    assert F.transformer_t2t_forward_flops(
        2, max_words=4, embed=8, hidden=8, n_layers=1, n_steps=3,
        codes=16) == pytest.approx(25_344.0)
    assert F.transformer_t2t_forward_flops(128, max_words=32, n_steps=4) \
        == pytest.approx(10_836_582_400.0)


def _sweep(name):
    """Argument sets for a count: its defaults (the benchmark shapes at
    batch 128) where it has them, then a grid of small shapes and each
    option's values."""
    small = (1, 3)
    grids = {
        "dense_flops": [dict(batch=b, in_dim=i, out_dim=o)
                        for b, i, o in itertools.product(small, (2, 5),
                                                         (4, 7))],
        "gru_cell_flops": [dict(batch=b, in_dim=i, hidden=h)
                           for b, i, h in itertools.product(small, (2, 5),
                                                            (3, 8))],
        "gru_flops": [dict(batch=b, seq=s, in_dim=5, hidden=h, n_layers=n,
                           bidirectional=bi)
                      for b, s, h, n, bi in itertools.product(
                          small, (1, 4), (3, 8), (1, 3), (False, True))],
        "dae_forward_flops": [dict(batch=b, motion_dim=m, latent=z)
                              for b, m, z in itertools.product(
                                  small, (12, 135), (4, 40))],
        "seq_ae_forward_flops": [
            dict(batch=b, n_frames=f, rep=6, hidden=h, n_layers=n,
                 codes=16, encoder=e)
            for b, f, h, n, e in itertools.product(
                small, (2, 5), (8, 12), (1, 2), ("bigru", "transformer"))],
        "text2token_forward_flops": [
            dict(batch=b, max_words=w, embed=10, hidden=8, n_layers=n,
                 n_steps=s, codes=16, encoder=e, kernel=k)
            for b, w, n, s, e, k in itertools.product(
                small, (4, 9), (1, 2), (2, 4), ("tcn", "gru"), (2, 3))],
        "transformer_t2t_forward_flops": [
            dict(batch=b, max_words=w, embed=e, hidden=8, n_layers=n,
                 n_steps=s, codes=16)
            for b, w, e, n, s in itertools.product(small, (4, 9), (8, 10),
                                                   (1, 2), (2, 5))],
        "e2e_decode_flops": [
            dict(n_tokens=t, n_frames=f, rep=6, hidden=8, n_layers=n,
                 motion_dim=m)
            for t, f, n, m in itertools.product((1, 7), (2, 20), (1, 2),
                                                (12, 135))]}
    if name in ("dense_flops", "gru_cell_flops", "gru_flops"):
        return grids[name]
    first = "n_tokens" if name == "e2e_decode_flops" else "batch"
    return [{first: 128}] + grids[name]


@pytest.mark.parametrize("name", COUNTS)
def test_analytic_counts_equal_jax(name):
    """The same formula: each count equals JAX's exactly at its defaults
    (the benchmark shapes, batch 128) and over the sweep."""
    from gesture2vec_tpu.utils import flops as JF

    ours, theirs = getattr(F, name), getattr(JF, name)
    for kw in _sweep(name):
        assert ours(**kw) == theirs(**kw), kw


def test_peaks_and_mfu():
    """The card's published peaks (no TPU figure), and mfu's arithmetic
    and default peak (bf16)."""
    assert (F.H100_PEAK_BF16, F.H100_PEAK_TF32, F.H100_PEAK_FP32,
            F.H100_PEAK_BYTES_S) == (989e12, 495e12, 67e12, 3.35e12)
    assert not hasattr(F, "V5E_PEAK_BF16")
    assert F.mfu(989e12, 2.0) == pytest.approx(0.5)
    assert F.mfu(67e12, 1.0, F.H100_PEAK_FP32) == pytest.approx(1.0)
    assert F.mfu(1e12, 0.0) == 0.0


def _band(analytic, counted):
    assert 0.8 * counted <= analytic <= 2.0 * counted, (analytic, counted)


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@torch.no_grad()
def test_counted_flops_dae(one_thread):
    from gesture2vec_tpu_torch.models.dae import DAE

    model = DAE(135, 40).eval()
    x = torch.zeros(128, 135)
    counted = F.counted_flops(model, x)
    assert counted == F.dae_forward_flops(128)
    _band(F.dae_forward_flops(128), counted)


@torch.no_grad()
def test_counted_flops_seq_ae(one_thread):
    """The tokenizer's eval forward at the benchmark widths on the plain
    CPU path (every GRU step a torch matmul, so counted)."""
    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.train.seq_ae_trainer import make_seq_ae

    cfg = load_config(dict(name="s", model="seq2seq", hidden_size=200,
                           n_layers=2, dropout_prob=0.2, epochs=1,
                           batch_size=8, rep_learning_dim=40, n_poses=20,
                           n_pre_poses=1, autoencoder_vq=True,
                           autoencoder_vq_components=512, random_seed=0))
    model = make_seq_ae(cfg).eval()
    x = torch.zeros(128, 20, 40)
    _band(F.seq_ae_forward_flops(128), F.counted_flops(model, x, x))


@torch.no_grad()
def test_counted_flops_text2token(one_thread):
    """The Part d (TCN encoder, attention decoder) at the benchmark
    widths, 32 words, on the plain CPU path."""
    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.train.text2token_trainer import \
        make_text2token

    cfg = load_config(dict(name="t", model="seq2seq", hidden_size=200,
                           n_layers=2, dropout_prob=0.2, epochs=1,
                           batch_size=8, n_poses=20, n_pre_poses=1,
                           wordembed_dim=300, sentence_frame_length=80,
                           autoencoder_vq_components=512, random_seed=0,
                           autoencoder_att=True))
    model = make_text2token(cfg, 8000).eval()
    rng = np.random.default_rng(0)
    words = torch.from_numpy(rng.integers(4, 8000, size=(128, 32)))
    lens = torch.full((128,), 32)
    tgt = torch.zeros(128, model.n_steps, dtype=torch.long)
    _band(F.text2token_forward_flops(128, max_words=32,
                                     n_steps=model.n_steps),
          F.counted_flops(model, words, lens, tgt))


def test_stage_timer():
    """tests/test_audio_ssl_reconstruct.py's case: counts per stage, the
    report line; sync mode with an output sink bills the stage."""
    t = profiling.StageTimer(sync=False)
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    assert t.counts["a"] == 2
    assert "a:" in t.report()

    t2 = profiling.StageTimer(sync=True)
    with t2.stage("mm") as done:
        x = torch.ones((64, 64))
        done(x @ x)
    assert t2.counts["mm"] == 1 and t2.totals["mm"] > 0


def test_stage_timer_report_matches_jax():
    """The same totals and counts give JAX's report, line for line
    (slowest stage first)."""
    from gesture2vec_tpu.utils.profiling import StageTimer as JaxTimer

    ours, theirs = profiling.StageTimer(sync=False), JaxTimer(sync=False)
    for timer in (ours, theirs):
        timer.totals.update({"encode": 0.25, "decode": 1.5, "io": 0.0625})
        timer.counts.update({"encode": 2, "decode": 3, "io": 1})
    assert ours.report() == theirs.report()
    assert ours.report().splitlines()[0].startswith("decode: 1.500s total")


def test_stage_timer_synchronises_where_cuda_is_used(monkeypatch):
    """sync: a stage without a sink synchronises the current CUDA device
    only once this process has initialised CUDA, on entry and on exit; a
    sink of CPU tensors waits for nothing; sync=False never waits."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    t = profiling.StageTimer(sync=True)
    with t.stage("cpu"):
        pass
    assert calls == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with t.stage("device"):
        pass
    assert calls == [None, None]
    with t.stage("sink") as done:
        done(torch.ones(3))
        done([{"a": torch.zeros(2)}])
    assert calls == [None, None, None]
    with profiling.StageTimer(sync=False).stage("off"):
        pass
    assert len(calls) == 3
    assert t.counts == {"cpu": 1, "device": 1, "sink": 1}


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace(dir) on the CPU writes one Chrome trace into dir, and an
    annotate()d stage shows up in it by name, under the port's g2v.
    prefix."""
    log_dir = str(tmp_path / "prof")
    with profiling.trace(log_dir):
        with profiling.annotate("g2v_stage"):
            x = torch.ones(32, 32)
            (x @ x).sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "g2v.g2v_stage" in names
    assert any("mm" in str(n) for n in names)
