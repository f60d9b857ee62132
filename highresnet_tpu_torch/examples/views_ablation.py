"""Views-scaling ablation: shift_cPSNR vs number of fused LR views.

Reproduces the shape of the paper's Fig. 1 (score improves monotonically
with views up to ~16, and 1-view is worse than the no-learning baseline)
on a trained checkpoint from ``quality_experiment``.

    python -m highresnet_tpu_torch.examples.views_ablation [--root <tmp>/hrn_quality_data] \
        [--checkpoint <run dir>] [--out build/examples/VIEWS_ABLATION.json] [--device cuda]

With no ``--checkpoint`` it takes the newest run directory under
``<root>/ckpt`` (a port run: ``best/HRNet.pth``).
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List, Sequence


def sweep(forward, scene_dirs: Sequence[str], views: Sequence[int], device) -> Dict[str, object]:
    """Per view count k, each scene's shift-cPSNR from its k clearest views and
    the raw SR's overflow out of [0, 1] (full frame and the scored region);
    plus each scene's bicubic score."""
    from highresnet_tpu_torch.data import collate
    from highresnet_tpu_torch.exp import harness

    max_views = max(views)
    per_k: Dict[int, List[float]] = {k: [] for k in views}
    overflow: Dict[int, List[float]] = {k: [] for k in views}
    overflow_scored: Dict[int, List[float]] = {k: [] for k in views}
    cubic = []
    for d in scene_dirs:
        s = harness.read_scene(d, max_views)
        score = harness.scene_scorer(s, device)
        for k in views:
            batch = collate([s], k)  # truncates to the k clearest views
            sr = forward(batch.lrs, batch.alphas)[0]
            per_k[k].append(score(sr))
            # clip-floor evidence: how far the raw output leaves [0,1] before
            # the metric clips it, full-frame and in the scored region
            ov_full, ov_scored = harness.overflow_metrics(sr.cpu())
            overflow[k].append(ov_full)
            overflow_scored[k].append(ov_scored)
        cubic.append(score(harness.bicubic_x3(s.lr[0], device)))
    return {"per_k": per_k, "overflow": overflow, "overflow_scored": overflow_scored,
            "bicubic": cubic}


def main(argv=None):
    from highresnet_tpu_torch.exp.harness import default_out, default_root

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=default_root("hrn_quality_data"))
    ap.add_argument("--checkpoint", default=None, help="run dir (default: newest in <root>/ckpt)")
    ap.add_argument("--views", type=int, nargs="+", default=[1, 2, 4, 8, 12, 16])
    ap.add_argument("--val-proportion", type=float, default=0.1)
    ap.add_argument("--max-scenes", type=int, default=20)
    ap.add_argument("--out", default=default_out("VIEWS_ABLATION.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from highresnet_tpu_torch.config import load_config
    from highresnet_tpu_torch.eval.evaluator import Forward, load_model
    from highresnet_tpu_torch.exp import harness
    from highresnet_tpu_torch.runtime import setup_device

    device = setup_device(args.device)
    run = args.checkpoint or sorted(glob.glob(os.path.join(args.root, "ckpt", "*")))[-1]
    max_views = max(args.views)
    config = load_config(overrides={"training": {"min_L": max_views, "n_views": max_views}})
    fwd = Forward.plain(load_model(config, run, device), device, host=False)

    val = harness.held_out_scenes(args.root, args.val_proportion, args.max_scenes)
    out = sweep(fwd, val, args.views, device)
    per_k = out["per_k"]

    bicubic = float(np.mean(out["bicubic"]))
    table = [
        {
            "views": k,
            "mean_shift_cpsnr": float(np.mean(v)),
            "vs_bicubic_db": round(float(np.mean(v)) - bicubic, 3),
            # >0.3 is the eval path's warn_out_of_range threshold
            "max_out_of_range": round(float(np.max(out["overflow"][k])), 4),
            # overflow inside the border-trimmed region the metric scores
            "max_out_of_range_scored": round(float(np.max(out["overflow_scored"][k])), 4),
        }
        for k, v in sorted(per_k.items())
    ]
    report = {
        "checkpoint": run,
        "n_scenes": len(val),
        "bicubic_mean_shift_cpsnr": bicubic,
        "by_views": table,
        "monotone_nondecreasing": all(
            table[i]["mean_shift_cpsnr"] <= table[i + 1]["mean_shift_cpsnr"] + 0.02
            for i in range(len(table) - 1)
        ),
    }
    harness.emit_report(args.out, report)
    return report


if __name__ == "__main__":
    main()
