"""Precompute per-view clearance scores (clearance.npy) for all scenes.

Usage (the JAX CLI's flags, the reference CLI's role, src/save_clearance.py):
    python -m highresnet_tpu_torch.cli.save_clearance --prefix data/

Every scene must have its clearance.npy before it is read for training or
serving; this writes it under each scene of ``train/`` and ``test/``.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--prefix", default="data/", help="root dir of the dataset")
    args = parser.parse_args(argv)
    if not os.path.isdir(args.prefix):
        parser.error(f"dataset root not found: {args.prefix}")

    from highresnet_tpu_torch.data.probav import discover_scenes, save_clearance_scores

    for split in ("train", "test"):
        split_dir = os.path.join(args.prefix, split)
        if os.path.isdir(split_dir):
            scenes = discover_scenes(split_dir)
            save_clearance_scores(scenes)
            print(f"{split}: wrote clearance.npy for {len(scenes)} scenes")


if __name__ == "__main__":
    main()
