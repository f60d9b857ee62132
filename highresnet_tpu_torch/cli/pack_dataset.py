"""Pack every scene into a decode-free .npz cache (input-pipeline speedup).

    python -m highresnet_tpu_torch.cli.pack_dataset --prefix data/

The same files as ``highresnet_tpu.cli.pack_dataset``; the loaders of
either package read them.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--prefix", default="data/", help="root dir of the dataset")
    args = parser.parse_args(argv)
    if not os.path.isdir(args.prefix):
        parser.error(f"dataset root not found: {args.prefix}")

    from highresnet_tpu_torch.data.pack import pack_scenes
    from highresnet_tpu_torch.data.probav import discover_scenes

    for split in ("train", "test"):
        split_dir = os.path.join(args.prefix, split)
        if os.path.isdir(split_dir):
            scenes = discover_scenes(split_dir)
            t0 = time.time()
            pack_scenes(scenes)
            print(f"{split}: packed {len(scenes)} scenes in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
