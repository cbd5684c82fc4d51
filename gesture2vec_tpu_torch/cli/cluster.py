"""CLI: build the corpus latent dataset, K-Means clusters, and metrics.

    python -m gesture2vec_tpu_torch.cli.cluster <DAE.bin> <VQ.bin> \\
        --store <train store> [--val-store <val store>] [--kmeans 300]

The port of the JAX package's `cli/cluster.py`, reading the same
checkpoint files and clip stores. It writes into --out (default
<VQ checkpoint dir>/clusters):
  org_latent_clustering_data.npz  windows, dae_latents, tokens,
                                  seq_latents of the train store;
  kmeans_model.npz                centers and inertia (--kmeans K);
  Metrics.txt, Metrics.tex        Hellinger / Frechet / perplexity /
                                  Wasserstein, train against val
                                  (--val-store);
  Rep_distance.txt                representation-space smoothness.
It runs on the card (--device cuda, the default) and raises without
one; --device cpu runs the plain PyTorch path. K-Means is seeded with
torch's generator (seed 0), so its clusters differ from the JAX
package's (jax.random); everything else matches it.

Not ported yet: --plots, --export-samples and --algo mapdp / dbscan /
agglomerative (ROADMAP.md queue A).
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

_LATER = "{} is not ported yet (the analysis slice of the PyTorch port)"


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("rep_checkpoint", help="Part-a checkpoint")
    parser.add_argument("autoencoder_checkpoint", help="Part-b checkpoint")
    parser.add_argument("--store", required=True,
                        help="train clip-store directory")
    parser.add_argument("--val-store", default=None)
    parser.add_argument("--out", default=None,
                        help="output dir (default: <ckpt dir>/clusters)")
    parser.add_argument("--kmeans", type=int, default=0,
                        help="fit K-Means with this many clusters "
                             "(the reference uses 300)")
    parser.add_argument("--algo", default="kmeans",
                        choices=["kmeans", "mapdp", "dbscan",
                                 "agglomerative"])
    parser.add_argument("--plots", action="store_true")
    parser.add_argument("--export-samples", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.plots:
        raise NotImplementedError(_LATER.format("--plots"))
    if args.export_samples:
        raise NotImplementedError(_LATER.format("--export-samples"))
    if args.kmeans > 0 and args.algo != "kmeans":
        raise NotImplementedError(_LATER.format(f"--algo {args.algo}"))

    from gesture2vec_tpu_torch.cluster.kmeans import kmeans_fit, save_kmeans
    from gesture2vec_tpu_torch.cluster.latent_dataset import (
        build_latent_dataset, save_latent_dataset)
    from gesture2vec_tpu_torch.cluster.metrics import (
        frechet_distance, hellinger, representation_neighbor_distance,
        token_histogram, token_perplexity, wasserstein_distance)
    from gesture2vec_tpu_torch.compat.checkpoint import \
        load_checkpoint_and_model
    from gesture2vec_tpu_torch.data.store import ClipStore

    logging.basicConfig(level=logging.INFO)
    out = args.out or os.path.join(
        os.path.dirname(args.autoencoder_checkpoint), "clusters")
    os.makedirs(out, exist_ok=True)

    dae_model, _ = load_checkpoint_and_model(args.rep_checkpoint, "DAE",
                                             args.device)
    seq_model, seq_payload = load_checkpoint_and_model(
        args.autoencoder_checkpoint, "autoencoder_vq", args.device)
    cfg = seq_payload["config"]
    n_poses, stride = int(cfg["n_poses"]), int(cfg["subdivision_stride"])
    store = ClipStore(args.store)
    summary = {"out": out}

    data = build_latent_dataset(store, dae_model=dae_model,
                                seq_model=seq_model, n_poses=n_poses,
                                stride=stride)
    path = os.path.join(out, "org_latent_clustering_data.npz")
    save_latent_dataset(path, data)
    k = int(cfg["autoencoder_vq_components"])
    summary["windows"] = len(data["tokens"])
    logging.info("latent dataset: %d windows -> %s", len(data["tokens"]),
                 path)
    logging.info("token perplexity: %.2f (of %d codes)",
                 token_perplexity(data["tokens"], k), k)

    if args.kmeans > 0:
        res = kmeans_fit(data["seq_latents"], args.kmeans,
                         device=args.device)
        save_kmeans(os.path.join(out, "kmeans_model.npz"), res)
        summary["kmeans_inertia"] = float(res.inertia)
        summary["kmeans_n_iter"] = res.n_iter
        logging.info("kmeans(%d) inertia %.2f, Lloyd steps %s", args.kmeans,
                     float(res.inertia), res.n_iter)

    if args.val_store:
        val = build_latent_dataset(ClipStore(args.val_store),
                                   dae_model=dae_model, seq_model=seq_model,
                                   n_poses=n_poses, stride=stride,
                                   mean=store.pose_mean, std=store.pose_std)
        summary["val_windows"] = len(val["tokens"])
        t_train, t_val = data["tokens"], val["tokens"]
        hel = hellinger(token_histogram(t_train, k),
                        token_histogram(t_val, k))
        fre = frechet_distance(data["seq_latents"], val["seq_latents"])
        lines = [f"Hellinger: {hel:.4f}", f"Frechet: {fre:.4f}",
                 f"Perplexity(train): {token_perplexity(t_train, k):.2f}",
                 f"Perplexity(val): {token_perplexity(t_val, k):.2f}",
                 f"Wasserstein: "
                 f"{wasserstein_distance(t_train, t_val):.4f}"]
        with open(os.path.join(out, "Metrics.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        vals = [ln.split(": ")[1] for ln in lines]
        with open(os.path.join(out, "Metrics.tex"), "w") as f:
            f.write("\\begin{tabular}{ccccc}\n\\toprule\n"
                    "Hellinger & Fr\\'echet & PPL(train) & PPL(val) & "
                    "Wasserstein \\\\\n\\midrule\n"
                    + " & ".join(vals) + " \\\\\n"
                    "\\bottomrule\n\\end{tabular}\n")
        for ln in lines:
            logging.info(ln)

    try:
        rep = representation_neighbor_distance(data["seq_latents"])
        with open(os.path.join(out, "Rep_distance.txt"), "w") as f:
            f.write("\n".join(f"{name}: {v:.6f}"
                              for name, v in rep.items())
                    + "\n")
        logging.info("Rep_distance: %s", rep)
    except ValueError as e:   # corpus too small for the +-2 strides
        logging.info("Rep_distance skipped: %s", e)
    return summary


if __name__ == "__main__":
    main()
