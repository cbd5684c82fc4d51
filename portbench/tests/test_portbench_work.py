"""The yardstick's frozen arithmetic, held equal to the program's own
counts today (`utils/flops`) and to the bring-up script's kernel bounds
(`chip_smoke.py`), at the benchmark's widths; the device readers refuse
to read without a card."""
import importlib.util
import json

import pytest

from conftest import ROOT

PAPER = json.loads((ROOT / "portbench/configs/g2v_paper.json").read_text())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_forward_counts_equal_utils_flops():
    from gesture2vec_tpu_torch.utils import flops
    from portbench.work import g2v

    c = PAPER
    kw = dict(max_words=c["max_words"], embed=c["wordembed_dim"],
              hidden=c["hidden_size"], n_layers=c["n_layers"], n_steps=6,
              codes=c["codes"])
    for batch in (1, 128, 2815):
        assert g2v.tcn_text2token_flops(batch, **kw) == \
            flops.text2token_forward_flops(batch, encoder="tcn", **kw)
        assert g2v.seq_ae_forward_flops(batch, 20, 40, 200, 2, 512) == \
            flops.seq_ae_forward_flops(batch, 20, 40, 200, 2, 512)
        assert g2v.dense_flops(batch * 120, 40, 135) == \
            flops.dae_forward_flops(batch * 120, 135, 40) \
            - flops.dense_flops(batch * 120, 135, 40)
    assert g2v.train_b_flops(c, 1) == 3 * flops.seq_ae_forward_flops(
        128, 20, 40, 200, 2, 512)


def test_kernel_bounds_equal_chip_smoke():
    from portbench.work import g2v, peaks

    cs = _chip_smoke()
    assert (peaks.PEAK_FP32_FLOPS, peaks.PEAK_BYTES_S,
            peaks.PEAK_BF16_FLOPS) == (cs.PEAK_FP32_FLOPS, cs.PEAK_BYTES_S,
                                       cs.H100_PEAK_BF16)
    for B in (6, 3072, 16890, 58368):
        f, b = g2v.chunk_decoder_work(B, 40, 200, 20)
        want = cs.chunk_decoder_bound_ms(B, 40, 200, 20)
        assert (f, b) == (want["flops"], want["bytes"])
        assert peaks.bound_s(f, b) * 1e3 == pytest.approx(want["bound_ms"])
    for fn, want in ((g2v.gru_forward_work, cs.gru_bound_ms),
                     (g2v.gru_gates_work, cs.gru_gates_bound_ms),
                     (g2v.gru_backward_work, cs.gru_backward_bound_ms)):
        f, b = fn(20, 128, 200)
        w = want(20, 128, 200)
        assert (f, b) == (w["flops"], w["bytes"])


def test_generation_counts_add_up():
    from portbench.work import g2v

    w, c, f = 2815, 2815 * 6, 2815 * 120
    base = g2v.chunk_decoder_work(c, 40, 200, 20)[0] \
        + g2v.dense_flops(f, 40, 135)
    assert g2v.generation_flops(PAPER, w, c, f) == \
        g2v.tcn_text2token_flops(w, 48, 300, 200, 2, 6, 512) + base


@pytest.mark.parametrize("name", ["mfu.gen", "chunk_decoder_roofline",
                                  "device.idle_share.gen",
                                  "infer.device_ops_per_window",
                                  "mfu.train", "gru_fwd_roofline",
                                  "gru_bwd_roofline",
                                  "device.idle_share.train",
                                  "train.device_ops_per_step"])
def test_device_readers_refuse_without_a_card(name, monkeypatch):
    import torch

    from portbench.harness import registry
    from portbench.harness.trace import Trace

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reader = registry.metric(name)
    trace = Trace([("chunk_decode_kernel", 0, 10),
                   ("gru_sequence_kernel", 10, 20),
                   ("gru_sequence_backward_kernel", 20, 30)], [], (0, 100))
    record = {"trace": trace, "windows": 3, "steps": 2, "model_flops": 1e9,
              "chunk_decoder_work": [(1e6, 1e6)],
              "gru_fwd_work": [(1e6, 1e6)], "gru_bwd_work": [(1e6, 1e6)]}
    with pytest.raises(RuntimeError):
        reader.read(record)
    assert reader.read({"trace": None}) is None


def test_trace_arithmetic():
    from portbench.harness.trace import SPAN_PREFIX, Trace

    t = Trace([("a", 10, 20), ("b", 15, 30), ("a", 50, 60)],
              [(SPAN_PREFIX + "x", 0, 40), (SPAN_PREFIX + "y", 40, 100)],
              (0, 100))
    assert t.busy_s() == pytest.approx(30e-9)
    assert t.gaps() == [(0, 10), (30, 50), (60, 100)]
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["a", pytest.approx(20e-9)]
    assert dict(bd["idle_gaps"]) == {"x": pytest.approx(10e-9),
                                     "y": pytest.approx(60e-9)}
