"""CLI: build the corpus latent dataset, K-Means clusters, and metrics.

    python -m gesture2vec_tpu_torch.cli.cluster <DAE.bin> <VQ.bin> \\
        --store <train store> [--val-store <val store>] [--kmeans 300] \\
        [--algo kmeans|mapdp|dbscan|agglomerative] [--plots] \\
        [--export-samples N --pipeline data_pipe.json]

The port of the JAX package's `cli/cluster.py`, reading the same
checkpoint files and clip stores. It writes into --out (default
<VQ checkpoint dir>/clusters):
  org_latent_clustering_data.npz  windows, dae_latents, tokens,
                                  seq_latents of the train store;
  kmeans_model.npz                centers and inertia (--kmeans K);
  mapdp_labels.npy, dbscan_labels.npy, agglomerative_labels.npy
                                  the labels of --algo mapdp (MAP-DP,
                                  numpy / scipy), dbscan (scikit-learn's
                                  defaults) or agglomerative (K clusters,
                                  scikit-learn) in place of K-Means;
  codebook_tsne.png, latents_tsne.png
                                  the codebook's and the first 2,000
                                  sequence latents' t-SNE (--plots:
                                  matplotlib, scikit-learn);
  samples/<token>/sample_<i>.bvh  the first N windows of each token,
                                  decoded by the DAE (--export-samples N,
                                  with --pipeline);
  Metrics.txt, Metrics.tex        Hellinger / Frechet / perplexity /
                                  Wasserstein, train against val
                                  (--val-store);
  Rep_distance.txt                representation-space smoothness.
It runs on the card (--device cuda, the default) and raises without
one; --device cpu runs the plain PyTorch path. K-Means is seeded with
torch's generator (seed 0), so its clusters differ from the JAX
package's (jax.random); everything else matches it. MAP-DP, DBSCAN,
agglomerative clustering and the plots are host code, as in JAX.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

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
    parser.add_argument("--plots", action="store_true",
                        help="write codebook/latent t-SNE plots")
    parser.add_argument("--export-samples", type=int, default=0,
                        help="write up to N BVH samples per token")
    parser.add_argument("--pipeline", default=None,
                        help="fitted data_pipe.json (for BVH exports)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    from gesture2vec_tpu_torch.cluster.plots import have_matplotlib
    if args.plots and not have_matplotlib():
        parser.error("--plots needs matplotlib")
    if args.export_samples > 0 and not args.pipeline:
        parser.error("--pipeline required for --export-samples")

    import numpy as np

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

    if args.kmeans > 0 and args.algo == "kmeans":
        res = kmeans_fit(data["seq_latents"], args.kmeans,
                         device=args.device)
        save_kmeans(os.path.join(out, "kmeans_model.npz"), res)
        summary["kmeans_inertia"] = float(res.inertia)
        summary["kmeans_n_iter"] = res.n_iter
        logging.info("kmeans(%d) inertia %.2f, Lloyd steps %s", args.kmeans,
                     float(res.inertia), res.n_iter)
    elif args.kmeans > 0 and args.algo == "mapdp":
        from gesture2vec_tpu_torch.cluster.mapdp import mapdp_nw
        res = mapdp_nw(data["seq_latents"])
        np.save(os.path.join(out, "mapdp_labels.npy"), res.labels)
        summary["clusters"] = res.k
        logging.info("mapdp found %d clusters", res.k)
    elif args.kmeans > 0:
        from sklearn.cluster import DBSCAN, AgglomerativeClustering
        if args.algo == "dbscan":
            labels = DBSCAN().fit_predict(data["seq_latents"])
        else:
            labels = AgglomerativeClustering(
                n_clusters=args.kmeans).fit_predict(data["seq_latents"])
        np.save(os.path.join(out, f"{args.algo}_labels.npy"), labels)
        summary["clusters"] = int(len(np.unique(labels)))
        logging.info("%s produced %d labels", args.algo,
                     summary["clusters"])

    if args.plots:
        from gesture2vec_tpu_torch.cluster.plots import (plot_codebook_tsne,
                                                         plot_latent_space)
        cb = seq_model.vq_layer.codebook.detach().cpu().numpy()
        usage = np.bincount(data["tokens"], minlength=cb.shape[0])
        plot_codebook_tsne(cb, os.path.join(out, "codebook_tsne.png"),
                           usage=usage)
        sub = data["seq_latents"][:2000]
        plot_latent_space(sub, os.path.join(out, "latents_tsne.png"),
                          labels=data["tokens"][:2000])
        logging.info("plots written to %s", out)

    if args.export_samples > 0:
        from gesture2vec_tpu_torch.cluster.latent_dataset import \
            export_cluster_samples
        from gesture2vec_tpu_torch.mocap.features import FeatureExtractor
        fe = FeatureExtractor.load(args.pipeline)
        n = export_cluster_samples(
            data, os.path.join(out, "samples"), fe, store.pose_mean,
            store.pose_std, dae_model, max_per_token=args.export_samples)
        summary["samples"] = n
        logging.info("wrote %d cluster sample BVHs", n)

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
