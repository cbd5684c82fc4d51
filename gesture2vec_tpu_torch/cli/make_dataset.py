"""CLI: build train/val clip stores from a corpus directory.

Mirrors `python trinity_data_to_lmdb.py <db_path>`
(ref: scripts/trinity_data_to_lmdb.py:156-161) and, with
--dataset twh, `python twh_dataset_to_lmdb.py <db_path>`
(ref: scripts/twh_dataset_to_lmdb.py:151-279).

The port's copy of the JAX package's `cli/make_dataset.py`, with the
same flags:

    python -m gesture2vec_tpu_torch.cli.make_dataset <corpus> [--out DIR]
"""
from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence, Tuple


def main(argv: Optional[Sequence[str]] = None) -> Tuple[str, str]:
    """Builds the stores; returns (train_store, val_store)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("base_path",
                        help="Trinity layout: Motion/ Transcripts/ "
                             "Audio/; TWH layout: bvh/ tsv/ wav/")
    parser.add_argument("--out", default=None,
                        help="output store dir (default <base>/store)")
    parser.add_argument("--dataset", choices=["trinity", "twh"],
                        default="trinity")
    parser.add_argument("--fps", type=int, default=20,
                        help="trinity only; TWH variants fix their own "
                             "rate like the reference")
    parser.add_argument("--twh-variant", default="test1",
                        choices=["posrot", "rot", "taras", "test1"],
                        help="which process_bvh* feature variant "
                             "(ref: twh_dataset_to_lmdb.py:26-148)")
    parser.add_argument("--max-files", type=int, default=50,
                        help="TWH file cap (ref :176 caps at 50)")
    parser.add_argument("--no-audio", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.dataset == "twh":
        from gesture2vec_tpu_torch.data.ingest import ingest_twh

        train_dir, val_dir = ingest_twh(args.base_path, args.out,
                                        variant=args.twh_variant,
                                        max_files=args.max_files,
                                        with_audio=not args.no_audio)
    else:
        from gesture2vec_tpu_torch.data.ingest import ingest_trinity

        train_dir, val_dir = ingest_trinity(args.base_path, args.out,
                                            tgt_fps=args.fps,
                                            with_audio=not args.no_audio)
    print(f"train store: {train_dir}")
    print(f"val store:   {val_dir}")
    return train_dir, val_dir


if __name__ == "__main__":
    main()
