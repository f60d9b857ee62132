"""Geometric self-ensemble (x8 TTA) on a trained checkpoint.

Measures, per held-out scene, the shift_cPSNR of:
  - ``single``  — the plain forward,
  - ``naive8`` / ``naive4``  — mean of the inverse-transformed dihedral
    outputs WITHOUT frame registration,
  - ``reg8`` / ``reg4``      — the shipped path (``Model.enable_tta``):
    every inverse-transformed output PCC-aligned to the identity-transform
    frame before averaging,
and the per-transform output-frame offsets that explain the difference:
the model's learned absolute output offset is NOT equivariant under the
dihedral action, so raw symmetry outputs are mutually shifted sharp images.

Scenes are scored in collated batches: one alignment call over the 7·B
non-identity outputs (K3 on the card) and one ``shift_cpsnr_batch`` over
the 5·B arm images per batch.

    python -m highresnet_tpu_torch.examples.tta_experiment [--root <tmp>/hrn_quality_full] \
        [--splits val fresh] [--out build/examples/TTA_REPORT.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os

ARMS = ("single", "naive8", "reg8", "naive4", "reg4")


def batch_scores(forward, lrs, alphas, hr, hr_map):
    """All arms for one collated batch: (scores (5, B), offsets (7, B, 2)),
    as tensors on the forward's device."""
    import torch

    from highresnet_tpu_torch.ops.dihedral import SAFE_SUBGROUP, dihedral_fwd, dihedral_inv
    from highresnet_tpu_torch.ops.metrics import shift_cpsnr_batch
    from highresnet_tpu_torch.registration.search import pcc_align_batch

    lrs = torch.as_tensor(lrs, dtype=torch.float32)
    srs = torch.stack([dihedral_inv(forward(dihedral_fwd(lrs, t), alphas), t)
                       for t in range(8)])  # (8, B, H, W)
    _, b, h, w = srs.shape
    anchor = srs[0]
    ref = anchor[None].expand(7, b, h, w).reshape(7 * b, h, w)
    aligned, d = pcc_align_batch(ref, srs[1:].reshape(7 * b, h, w))
    reg = torch.cat([anchor[None], aligned.reshape(7, b, h, w)])  # (8, B, H, W)
    sub = list(SAFE_SUBGROUP)  # the 4-element shape-safe subgroup
    arms = torch.stack([anchor, srs.mean(0), reg.mean(0), srs[sub].mean(0), reg[sub].mean(0)])
    hr = torch.as_tensor(hr, dtype=torch.float32, device=srs.device)
    hr_map = torch.as_tensor(hr_map, dtype=torch.float32, device=srs.device)
    scores = shift_cpsnr_batch(arms.clamp(0.0, 1.0).reshape(5 * b, h, w),
                               hr.repeat(5, 1, 1), hr_map.repeat(5, 1, 1))
    return scores.reshape(5, b), d.reshape(7, b, 2)


def run_split(forward, dirs, views: int, batch_size: int, label: str):
    """Per-scene rows and the split's summary (scenes past the last whole
    batch are left out)."""
    import numpy as np

    from highresnet_tpu_torch.data import collate
    from highresnet_tpu_torch.exp import harness

    rows, offsets = [], []
    for i in range(0, len(dirs) - len(dirs) % batch_size, batch_size):
        sets = [harness.read_scene(d, views) for d in dirs[i:i + batch_size]]
        bt = collate(sets, views)
        scores, d = batch_scores(forward, bt.lrs, bt.alphas, bt.hrs, bt.hr_maps)
        scores, d = scores.cpu().numpy(), d.cpu().numpy()
        for j, s in enumerate(sets):
            rows.append({"scene": s.name, **{a: float(scores[k, j]) for k, a in enumerate(ARMS)}})
        offsets.append(d)
        if (i // batch_size) % 5 == 4:
            print(f"[{label}] {len(rows)}/{len(dirs)}", flush=True)
    d = np.concatenate(offsets, axis=1)  # (7, N, 2)
    means = {a: float(np.mean([r[a] for r in rows])) for a in ARMS}
    best_tta = max((a for a in ARMS if a != "single"), key=means.get)
    delta = np.array([r[best_tta] - r["single"] for r in rows])
    return rows, {
        "n_scenes": len(rows),
        "mean_shift_cpsnr": {a: round(v, 4) for a, v in means.items()},
        "best_tta_arm": best_tta,
        "best_tta_minus_single_db": round(means[best_tta] - means["single"], 3),
        "reg8_minus_naive8_db": round(means["reg8"] - means["naive8"], 3),
        "best_tta_wins_vs_single": f"{int((delta > 0).sum())}/{len(rows)}",
        "paired_t": round(float(
            delta.mean() / (delta.std(ddof=1) / np.sqrt(len(delta)))), 2),
        "per_transform_offset_px": {
            f"t{t + 1}": {
                "mean_dyx": [round(float(m), 3) for m in d[t].mean(axis=0)],
                "std_dyx": [round(float(s), 3) for s in d[t].std(axis=0)],
            }
            for t in range(7)
        },
    }


def main(argv=None):
    from highresnet_tpu_torch.exp.harness import default_out, default_root

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=default_root("hrn_quality_full"))
    ap.add_argument("--run", default=None,
                    help="run dir with best/ (default: newest under <root>/ckpt)")
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--val-proportion", type=float, default=0.25)
    ap.add_argument("--fresh-dir", default="fresh_test_77",
                    help="fresh never-seen dataset subdir (train/ inside)")
    ap.add_argument("--splits", nargs="+", default=["val", "fresh"],
                    choices=["val", "fresh"])
    ap.add_argument("--max-scenes", type=int, default=0, help="0 = all")
    ap.add_argument("--out", default=default_out("TTA_REPORT.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from highresnet_tpu_torch.config import load_config
    from highresnet_tpu_torch.data import discover_scenes, train_val_split
    from highresnet_tpu_torch.eval.evaluator import Forward, load_model
    from highresnet_tpu_torch.exp import harness
    from highresnet_tpu_torch.runtime import setup_device

    device = setup_device(args.device)
    run = args.run or sorted(glob.glob(os.path.join(args.root, "ckpt", "*")))[-1]
    cfg = load_config(overrides={"training": {"min_L": args.views, "n_views": args.views}})
    fwd = Forward.plain(load_model(cfg, run, device), device, host=False)
    print(f"checkpoint: {run}", flush=True)

    report = {
        "what": ("Geometric self-ensemble (dihedral TTA) on a trained "
                 "checkpoint; registered vs naive averaging of the 8 symmetry "
                 "outputs (Model.enable_tta ships the registered path)"),
        "checkpoint": run,
        "views": args.views,
    }
    if "val" in args.splits:
        scenes = discover_scenes(os.path.join(args.root, "train"))
        _, val = train_val_split(scenes, args.val_proportion, seed=1)
        if args.max_scenes:
            val = val[:args.max_scenes]
        _, summary = run_split(fwd, val, args.views, args.batch, "val")
        report["val_split"] = summary
    if "fresh" in args.splits:
        fresh = discover_scenes(os.path.join(args.root, args.fresh_dir, "train"))
        if args.max_scenes:
            fresh = fresh[:args.max_scenes]
        fr_rows, fr_summary = run_split(fwd, fresh, args.views, args.batch, "fresh")
        report["fresh_test"] = fr_summary
        report["per_scene_fresh"] = fr_rows

    harness.emit_report(args.out, report, slim_drop=("per_scene_fresh",))
    return report


if __name__ == "__main__":
    main()
