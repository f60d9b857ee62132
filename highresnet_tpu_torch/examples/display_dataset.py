"""Browse a Proba-V(-format) dataset — the `Display dataset.ipynb` capability.

Renders HR / status-map / LR-view panels with histograms for a few scenes
and saves them as PNGs (headless: matplotlib's Agg backend, imported only
when the driver runs).

    python -m highresnet_tpu_torch.examples.display_dataset --data data/ --out /tmp/scenes --n 3
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", default="data/")
    parser.add_argument("--out", default="scene_previews")
    parser.add_argument("--n", type=int, default=3)
    parser.add_argument("--synthetic", action="store_true",
                        help="generate a synthetic dataset under --data first")
    args = parser.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from highresnet_tpu_torch.data import SceneDataset, discover_scenes, make_synthetic_dataset
    from highresnet_tpu_torch.utils.display import imsetshow

    if args.synthetic:
        make_synthetic_dataset(args.data, n_scenes_per_channel=2, n_views=6, lr_size=64)

    scenes = discover_scenes(os.path.join(args.data, "train"))
    ds = SceneDataset(scenes, top_k=-1)
    os.makedirs(args.out, exist_ok=True)
    paths = []
    for i in range(min(args.n, len(ds))):
        imset = ds[i]
        print(imset)
        fig = imsetshow(imset, k=min(4, imset.lr.shape[0]), show=False)
        path = os.path.join(args.out, f"{imset.name}.png")
        fig.savefig(path, dpi=90, bbox_inches="tight")
        plt.close(fig)
        print(f"-> {path}\n")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
