"""The multi-rank dry run: one step of every trainer over n gloo ranks.

The port's counterpart of the JAX package's `dryrun_multichip`
(`__graft_entry__.py`): `dryrun_multichip(n)` starts n gloo ranks on the
CPU (`parallel/launch`) and runs, at tiny shapes, every training path
over a mesh of them: Parts a, b and d (dp x tp, tp = 2 when n is even),
the transformer Part d, the baseline, audio2token, c2g and the GAN (dp
= n / tp), the GPipe pipeline (dp x pp, its forward and gradients held
against the sequential stack) and the corpus sweep over an "sp" axis
(held against the single sweep). Rank 0's report lines come back.

    python -m gesture2vec_tpu_torch.parallel.dryrun 4
"""
from __future__ import annotations

import sys
from typing import List

import numpy as np
import torch


def _ranks(n: int) -> List[str]:
    """Every rank runs this; rank 0's lines are the report."""
    from gesture2vec_tpu_torch.data.teacher import encode_windows_with_dae
    from gesture2vec_tpu_torch.models.gru import gru_layer
    from gesture2vec_tpu_torch.parallel.mesh import make_mesh
    from gesture2vec_tpu_torch.parallel.pipeline import (
        pipelined_gru_stack, stack_stages)
    from gesture2vec_tpu_torch.train.audio2token_trainer import \
        train_audio2token
    from gesture2vec_tpu_torch.train.config import load_config
    from gesture2vec_tpu_torch.train.dae_trainer import train_dae
    from gesture2vec_tpu_torch.train.gan_trainer import train_gan
    from gesture2vec_tpu_torch.train.misc_trainers import (train_baseline,
                                                           train_c2g)
    from gesture2vec_tpu_torch.train.seq_ae_trainer import train_seq_ae
    from gesture2vec_tpu_torch.train.text2token_trainer import \
        train_text2token

    tp = 2 if n % 2 == 0 and n > 1 else 1
    dp = n // tp
    shape = {"dp": dp, "tp": tp}
    lines = []

    def ok(what: str, value: float) -> None:
        if not np.isfinite(value):
            raise AssertionError(f"{what}: non-finite {value}")
        lines.append(f"dryrun_multichip OK ({what}): {value:.4f}")

    cfg = load_config(dict(
        name="dryrun", model="seq2seq", hidden_size=32, n_layers=2,
        dropout_prob=0.2, epochs=1, batch_size=2 * dp,
        learning_rate=1e-3, rep_learning_dim=16, n_poses=8, n_pre_poses=1,
        autoencoder_vq=True, autoencoder_vq_components=64,
        autoencoder_att=False, autoencoder_conditioned=True,
        random_seed=0, mesh_shape=shape))
    rng = np.random.default_rng(0)
    win = rng.normal(size=(2 * dp, 8, 16)).astype(np.float32)
    _, h = train_seq_ae(cfg, win, win, device="cpu")
    ok(f"part b, dp={dp} tp={tp}", h["train_loss"][0])

    t2t = cfg.replace(sentence_frame_length=4 * cfg.n_poses,
                      autoencoder_att=True, wordembed_dim=16)
    rd = np.random.default_rng(1)
    data = {"word_ids": rd.integers(0, 128, (2 * dp, 16)).astype(np.int32),
            "lengths": np.full((2 * dp,), 16, np.int32),
            "tokens": rd.integers(0, 64, (2 * dp, 4)).astype(np.int32)}
    _, h = train_text2token(t2t, data, data, n_words=128, device="cpu")
    ok("part d", h["train_loss"][0])
    tft = t2t.replace(extras={**t2t.extras, "t2t_arch": "transformer"})
    _, h = train_text2token(tft, data, data, n_words=128, device="cpu")
    ok("part d transformer", h["train_loss"][0])

    dcfg = cfg.replace(model="DAE", input_motion_dim=24, hidden_size=16,
                       autoencoder_vq=False, batch_size=4 * dp)
    frames = np.random.default_rng(2).normal(size=(4 * dp, 24)).astype(
        np.float32)
    dae, h = train_dae(dcfg, frames, frames, device="cpu")
    ok("part a", h["train_loss"][0])

    only_dp = {"dp": n}
    rb = np.random.default_rng(3)
    bdata = {"word_ids": rb.integers(0, 64, (4 * n, 12)).astype(np.int32),
             "lengths": np.full((4 * n,), 12, np.int32),
             "poses": rb.normal(size=(4 * n, 8, 24)).astype(np.float32)}
    bcfg = cfg.replace(model="baseline", mesh_shape=only_dp,
                       batch_size=4 * n, wordembed_dim=16)
    _, h = train_baseline(bcfg, bdata, bdata, n_words=64, device="cpu")
    ok(f"baseline trainer, dp={n}", h["train_loss"][0])

    acfg = cfg.replace(mesh_shape=only_dp, batch_size=4 * n,
                       sentence_frame_length=2 * cfg.n_poses,
                       autoencoder_att=True, autoencoder_vq_components=16)
    ra = np.random.default_rng(4)
    adata = {"mel": ra.normal(size=(4 * n, 2, 128, 32)).astype(np.float32),
             "tokens": ra.integers(0, 16, (4 * n, 2)).astype(np.int32)}
    _, h = train_audio2token(acfg, adata, adata, device="cpu")
    ok(f"audio2token trainer, dp={n}", h["train_loss"][0])

    ccfg = cfg.replace(mesh_shape=only_dp, batch_size=4 * n,
                       autoencoder_vq_components=16)
    rc = np.random.default_rng(5)
    cids = rc.integers(0, 16, (4 * n,)).astype(np.int32)
    clat = rc.normal(size=(4 * n, cfg.n_poses, 12)).astype(np.float32)
    _, h = train_c2g(ccfg, cids, clat, cids, clat, device="cpu")
    ok(f"c2g trainer, dp={n}", h["train_loss"][0])

    gcfg = cfg.replace(mesh_shape=only_dp, batch_size=4 * n,
                       wordembed_dim=16, noise_dim=8,
                       autoencoder_vq_components=16)
    _, h = train_gan(gcfg, bdata, n_words=64, device="cpu")
    ok(f"gan trainer, dp={n}", h["g_loss"][0])

    pp = 2 if n % 2 == 0 and n > 1 else 1
    ppdp = n // pp
    pp_mesh = make_mesh({"dp": ppdp, "pp": pp}, "cpu")
    rp = np.random.default_rng(6)
    H = 16
    layers = [{
        "w_ih": torch.from_numpy(rp.normal(size=(3 * H, H), scale=0.2)
                                 .astype(np.float32)),
        "w_hh": torch.from_numpy(rp.normal(size=(3 * H, H), scale=0.2)
                                 .astype(np.float32)),
        "b_ih": torch.zeros(3 * H), "b_hh": torch.zeros(3 * H)}
        for _ in range(pp)]
    stacked = {k: v.clone().requires_grad_() for k, v in
               stack_stages(layers).items()}
    x = torch.from_numpy(rp.normal(size=(4 * ppdp, 6, H)).astype(
        np.float32))
    y = pipelined_gru_stack(x, stacked, mesh=pp_mesh, n_micro=4)
    torch.mean(y ** 2).backward()
    for w in layers:
        for v in w.values():
            v.requires_grad_()
    ref = x.transpose(0, 1)
    for w in layers:
        ref, _ = gru_layer(ref, torch.zeros(x.shape[0], H), w["w_ih"],
                           w["w_hh"], w["b_ih"], w["b_hh"])
    ref = ref.transpose(0, 1)
    torch.mean(ref ** 2).backward()
    err = float((y - ref).abs().max())
    gerr = max(float((stacked[k].grad[i] - w[k].grad).abs().max())
               for i, w in enumerate(layers) for k in w)
    if err > 1e-4 or gerr > 1e-4:
        raise AssertionError(f"pp mismatch: forward {err}, grads {gerr}")
    lines.append(f"dryrun_multichip OK (pipeline parallel): dp={ppdp} "
                 f"pp={pp}, fwd err={err:.2e}, grad err={gerr:.2e}")

    sp_mesh = make_mesh({"sp": n}, "cpu")
    wins = np.random.default_rng(7).normal(size=(3 * n + 1, 3, 24)).astype(
        np.float32)
    l0 = encode_windows_with_dae(dae, wins, batch=8)
    l1 = encode_windows_with_dae(dae, wins, batch=8, mesh=sp_mesh)
    np.testing.assert_allclose(l0, l1, rtol=1e-6, atol=1e-6)
    lines.append(f"dryrun_multichip OK (sp corpus sweep): sp={n}, sweep "
                 f"identical")
    return lines


def dryrun_multichip(n_devices: int) -> List[str]:
    """Run the dry run over n_devices gloo ranks on the CPU; prints and
    returns rank 0's report lines. Raises where a path fails."""
    from gesture2vec_tpu_torch.parallel.launch import run
    lines = run(_ranks, (int(n_devices),), world_size=int(n_devices),
                device="cpu")
    lines.append(f"dryrun_multichip OK: all 7 training paths (a, b, d, "
                 f"baseline, audio2token, c2g, gan) + the part-d "
                 f"transformer on {n_devices} gloo ranks + pp (GPipe) and "
                 f"sp (sharded sweep)")
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
