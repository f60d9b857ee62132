"""Train-from-scratch quality evidence: MFSR beats single-view baselines.

Generates a synthetic Proba-V-format dataset whose HR scenes carry
band-limited detail in the aliased-but-surviving wavelength band (see
data/synth.py), trains HRNet+ShiftNet from scratch through
``train/loop.py::train_and_get_best_model``, then scores held-out
validation scenes:

  - trained HRNet with all views (MFSR),
  - trained HRNet with 1 view (SISR ablation),
  - bicubic 3x upsampling of the clearest LR view (no-learning baseline).

The claim under test (paper Table 1 / Fig. 1 in spirit): the trained
multi-frame model recovers aliased detail no single-view method can, so
MFSR shift_cPSNR > bicubic shift_cPSNR on held-out scenes.

    python -m highresnet_tpu_torch.examples.quality_experiment [--epochs 250] \
        [--out build/examples/QUALITY_REPORT.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    from highresnet_tpu_torch.exp.harness import default_out, default_root

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=default_root("hrn_quality_data"))
    ap.add_argument("--scenes-per-channel", type=int, default=24)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--lr-size", type=int, default=48)
    ap.add_argument("--detail", type=float, default=0.5)
    ap.add_argument("--hr-shift", type=float, default=0.0)
    ap.add_argument("--epochs", type=int, default=250)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--patch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=7e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--val-proportion", type=float, default=0.25)
    ap.add_argument(
        "--grad-clip-norm", type=float, default=0.0,
        help="training.grad_clip_norm passthrough (0 = off, the reference-exact default)",
    )
    ap.add_argument(
        "--ema-decay", type=float, default=0.0,
        help="training.ema_decay passthrough (0 = off): eval/best-model "
        "selection then score the parameter EMA",
    )
    ap.add_argument(
        "--augment", action="store_true",
        help="training.augment_dihedral: per-scene random D4 rotation/flip "
        "each epoch (extension; the reference never augments)",
    )
    ap.add_argument(
        "--lr-decay", type=float, default=0.97,
        help="training.lr_decay passthrough (plateau factor; 1.0 = constant LR)",
    )
    ap.add_argument(
        "--variable-views-p", type=float, default=0.0,
        help="training.variable_views_p passthrough: per-scene probability "
        "of truncating to a random view count so one checkpoint serves 1..n_views",
    )
    ap.add_argument(
        "--early-stop-patience", type=int, default=0,
        help="training.early_stop_patience passthrough (0 = run all epochs)",
    )
    ap.add_argument(
        "--val-views", type=int, nargs="*", default=[],
        help="training.val_views passthrough: score validation at these "
        "view counts too and select on the mean (full stack always included)",
    )
    ap.add_argument(
        "--range-penalty", type=float, default=0.0,
        help="training.range_penalty passthrough: penalize SR output that leaves [0,1]",
    )
    ap.add_argument(
        "--init-from", default="",
        help="training.init_params_from passthrough: fine-tune from another "
        "run's best/ snapshot (value = that run's run_dir) instead of a fresh init",
    )
    ap.add_argument(
        "--run-name", default="run",
        help="checkpoint run-dir name under <root>/ckpt — give each arm of "
        "a multi-arm experiment its own name so resumable runs don't collide",
    )
    ap.add_argument("--regen", action="store_true", help="rebuild the dataset")
    ap.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="epochs between resumable full-state checkpoints; with a stable "
        "run dir (<root>/ckpt/<run-name>) a relaunch resumes the run",
    )
    ap.add_argument("--out", default=default_out("QUALITY_REPORT.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from highresnet_tpu_torch.config import load_config
    from highresnet_tpu_torch.eval.evaluator import _Forward
    from highresnet_tpu_torch.exp import harness
    from highresnet_tpu_torch.runtime import setup_device
    from highresnet_tpu_torch.train.loop import train_and_get_best_model

    device = setup_device(args.device)

    # --- dataset (best-model selection on raw -shift_cPSNR, no norm.csv) --
    harness.ensure_dataset(
        args.root,
        scenes_per_channel=args.scenes_per_channel,
        views=args.views,
        lr_size=args.lr_size,
        seed=args.seed,
        detail=args.detail,
        hr_shift=args.hr_shift,
        regen=args.regen,
    )

    # --- train ----------------------------------------------------------
    config = load_config(
        overrides={
            "paths": {
                "prefix": args.root,
                "checkpoint_dir": os.path.join(args.root, "ckpt"),
                "tb_log_file_dir": "",
            },
            "training": {
                "num_epochs": args.epochs,
                "batch_size": args.batch,
                "n_views": args.views,
                "min_L": args.views,
                "patch_size": args.patch,
                "register_size": 2 * args.patch,  # < default 128: small scenes
                "val_proportion": args.val_proportion,
                "eval_batch_size": 4,
                "checkpoint_every": args.checkpoint_every,
                "lr": args.lr,
                "lr_decay": args.lr_decay,
                "grad_clip_norm": args.grad_clip_norm,
                "ema_decay": args.ema_decay,
                "augment_dihedral": args.augment,
                "variable_views_p": args.variable_views_p,
                "early_stop_patience": args.early_stop_patience,
                "init_params_from": args.init_from,
                "range_penalty": args.range_penalty,
                "val_views": args.val_views,
                "data_parallel": False,
            },
        }
    )
    # stable run dir iff checkpointing: a relaunch resumes (or, when
    # training already finished, serves the saved best weights)
    run_dir = (
        os.path.join(args.root, "ckpt", args.run_name) if args.checkpoint_every else None
    )
    t0 = time.time()
    result = train_and_get_best_model(config, run_dir=run_dir, device=device)
    train_s = time.time() - t0
    print(f"trained {args.epochs} epochs in {train_s:.0f}s; best={result['best_score']:.3f}")

    # --- score held-out validation scenes --------------------------------
    fwd = _Forward(harness.model_from_params(config, result["params"]["hrnet"], device), device,
                   host=False)
    val = harness.held_out_scenes(args.root, args.val_proportion)
    rows = harness.mfsr_rows(fwd, val, args.views, device, log=True)

    mean = {k: float(np.mean([r[k] for r in rows])) for k in ("mfsr", "one_view", "bicubic")}
    wins = sum(r["mfsr"] > r["bicubic"] for r in rows)
    report = {
        "protocol": {
            "scenes": 2 * args.scenes_per_channel,
            "views": args.views,
            "lr_size": args.lr_size,
            "detail": args.detail,
            "hr_shift": args.hr_shift,
            "epochs": args.epochs,
            "batch": args.batch,
            "patch": args.patch,
            "lr": args.lr,
            "lr_decay": args.lr_decay,
            "seed": args.seed,
            "val_proportion": args.val_proportion,
            "grad_clip_norm": args.grad_clip_norm,
            "ema_decay": args.ema_decay,
            "augment_dihedral": args.augment,
            "variable_views_p": args.variable_views_p,
            "early_stop_patience": args.early_stop_patience,
            "init_params_from": args.init_from,
            "range_penalty": args.range_penalty,
            "val_views": args.val_views,
            # on a resumed run this is the LAST leg only, not cumulative
            "train_seconds": round(train_s, 1),
            "device": harness.device_label(device),
        },
        # selection evidence (NOT protocol): the loop's internal val optimum,
        # when it happened and the per-epoch selection-score trajectory
        "selection": {
            "loop_best_score": round(float(result["best_score"]), 4),
            "best_epoch": int(result.get("best_epoch", -1)),
            "val_history": [
                [int(e), round(float(s), 4)]
                for e, s in result.get("val_history", [])
            ],
            # with ema_decay > 0: which weights the dual selection shipped
            # plus the per-epoch EMA-vs-raw win tally
            **({"ema": result["ema_selection"]} if "ema_selection" in result else {}),
        },
        "val_mean_shift_cpsnr": mean,
        "mfsr_minus_bicubic_db": round(mean["mfsr"] - mean["bicubic"], 3),
        "mfsr_minus_one_view_db": round(mean["mfsr"] - mean["one_view"], 3),
        "scenes_where_mfsr_beats_bicubic": f"{wins}/{len(rows)}",
        "per_scene": rows,
    }
    harness.emit_report(args.out, report, slim_drop=("per_scene",))
    return report


if __name__ == "__main__":
    main()
