"""CLI: autoencoder round-trip reconstruction of a BVH file.

    python -m gesture2vec_tpu_torch.cli.reconstruct dae.bin clip.bvh \\
        --store STORE --pipeline data_pipe.json \\
        [--autoencoder-checkpoint vq.bin] [--overlap 5] [--warmup-steps 5] \\
        [--out reconstructed.bvh] [--html-player clip.html] \\
        [--plot-kernels DIR] [--device cpu]

The port of the JAX package's `cli/reconstruct.py`, with the same
arguments; `--device` (default cuda) takes the place of `--platform`.
The BVH's features (the fitted pipeline's transform, no refit) are
normalised with the store's statistics and round-tripped through the
Part-a DAE alone, or with `--autoencoder-checkpoint` chunk by chunk
through the DAE and the Part-b tokenizer (`infer/reconstruct`), then
unnormalised and written as BVH. On the card the eval decode runs the
chunk-decoder kernel; for a tokenizer the kernel does not compute
(`SeqDecoder.kernel_reason`: decoder attention, a parity checkpoint's
eval step dropout) the decode runs in plain PyTorch, a choice logged
before the run. `--plot-kernels` needs matplotlib; `--html-player`
writes a self-contained HTML stick-figure player (`mocap/viz`).
`main(argv)` returns {"frames": the normalised reconstruction, "mse":
its mean squared error against the input, "out": the BVH path,
"kernel": whether the decode ran the kernel, "plots", "html"}.
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("rep_checkpoint", help="Part-a checkpoint")
    parser.add_argument("bvh", help="input BVH file")
    parser.add_argument("--autoencoder-checkpoint", default=None,
                        help="Part-b checkpoint (enables the chunked "
                             "a+b round trip)")
    parser.add_argument("--store", required=True,
                        help="train store (mean/std)")
    parser.add_argument("--pipeline", required=True,
                        help="fitted data_pipe.json")
    parser.add_argument("--out", default="reconstructed.bvh")
    parser.add_argument("--overlap", type=int, default=0,
                        help="chunk overlap frames (cross-fade blended)")
    parser.add_argument("--warmup-steps", type=int, default=0,
                        help="decoder hidden warm-up repeats before each "
                             "chunk rollout (the reference uses 5)")
    parser.add_argument("--plot-kernels", default=None, metavar="DIR",
                        help="render each DAE encoder unit as a stick "
                             "figure + heatmaps (needs matplotlib)")
    parser.add_argument("--html-player", default=None, metavar="FILE",
                        help="write a self-contained HTML player of the "
                             "reconstruction")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda raises without a card; "
                             "cpu runs the plain PyTorch path)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    from gesture2vec_tpu_torch.cluster.plots import have_matplotlib
    if args.plot_kernels and not have_matplotlib():
        parser.error("--plot-kernels needs matplotlib")

    import numpy as np

    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.datasets import normalize, unnormalize
    from gesture2vec_tpu_torch.data.store import ClipStore
    from gesture2vec_tpu_torch.infer.exporter import frames_to_bvh
    from gesture2vec_tpu_torch.infer.reconstruct import (chunked_reconstruct,
                                                         dae_roundtrip)
    from gesture2vec_tpu_torch.io.bvh import parse_bvh
    from gesture2vec_tpu_torch.mocap.features import FeatureExtractor

    logging.basicConfig(level=logging.INFO)
    store = ClipStore(args.store)
    fe = FeatureExtractor.load(args.pipeline)
    feats = fe.transform(parse_bvh(args.bvh))
    frames = normalize(feats.astype(np.float32), store.pose_mean,
                       store.pose_std)

    dae_model, _ = load_checkpoint_and_model(args.rep_checkpoint, "DAE",
                                             args.device)
    result = {"kernel": False}
    if args.autoencoder_checkpoint:
        seq_model, seq_payload = load_checkpoint_and_model(
            args.autoencoder_checkpoint, "autoencoder_vq", args.device)
        reason = seq_model.decoder.kernel_reason()
        if reason:
            seq_model.decoder.use_kernel = False
            logging.info("the eval decode runs in plain PyTorch: %s",
                         reason)
        result["kernel"] = not reason
        recon = chunked_reconstruct(seq_model, dae_model, frames,
                                    int(seq_payload["config"]["n_poses"]),
                                    overlap=args.overlap,
                                    warmup_steps=args.warmup_steps)
        logging.info("part a+b chunked round trip (%d frames)",
                     recon.shape[0])
    else:
        recon, _ = dae_roundtrip(dae_model, frames)
        logging.info("part a round trip (%d frames)", recon.shape[0])

    err = float(np.mean((recon - frames) ** 2))
    logging.info("reconstruction MSE (normalized space): %.5f", err)
    out_frames = unnormalize(recon, store.pose_mean, store.pose_std)
    data = frames_to_bvh(out_frames, fe, path=args.out)
    print(f"wrote {args.out} (MSE {err:.5f})")
    result.update(frames=recon, mse=err, out=args.out)

    if args.plot_kernels:
        from gesture2vec_tpu_torch.cluster.analysis import \
            plot_kernel_stickfigures
        # the JAX layout (motion_dim, latent_dim)
        kernel = dae_model.encoder.weight.detach().cpu().numpy().T
        written = plot_kernel_stickfigures(kernel, fe, store.pose_mean,
                                           store.pose_std,
                                           args.plot_kernels)
        print(f"wrote {len(written)} kernel plots -> {args.plot_kernels}")
        result["plots"] = written

    if args.html_player:
        from gesture2vec_tpu_torch.mocap.viz import save_html_player
        if data is None:
            data = parse_bvh(args.out)
        save_html_player(data, args.html_player,
                         title=f"reconstruction of {args.bvh}")
        print(f"wrote {args.html_player}")
        result["html"] = args.html_player
    return result


if __name__ == "__main__":
    main()
