"""Flagship recipe composition: ALL measured quality mechanisms, one run.

Measures the composite of the quality mechanisms the framework adds over
the reference — the registered loss with its ShiftNet warm-start and
unregistered-warmup curriculum, D4 train-time augmentation, and x8
registered TTA at inference — against reference-default training, both
scored plain and with TTA, on a FRESH test set (different generator seed,
untouched by training or model selection).

Arms (same dataset, same protocol, differ only in the recipe knobs):
  plain : register=False, no augmentation   (the reference's defaults
          minus loss-time registration)
  full  : registered loss + ShiftNet warm-start + unregistered-warmup
          curriculum + D4 augmentation      (this framework's recipe)

Scoring modes per arm: plain forward, and x8 dihedral TTA with PCC
registration to the identity frame (eval/evaluator.py::Forward.tta). The
headline is full+TTA minus plain — what a user gains by switching the
reference's training defaults to this framework's recipe.

    python -m highresnet_tpu_torch.examples.flagship_recipe [--epochs 300] \
        [--train-seed N] [--out build/examples/FLAGSHIP_RECIPE.json] [--device cuda]

``--seed`` makes the train and test sets; ``--train-seed`` sets only
``training.seed`` (weights, loader sampling, warm-start draws), which
otherwise stays at the config's 123. Given, it is recorded under
``protocol.train_seed`` and names the arms' run dirs, so runs at several
training seeds share one dataset without resuming each other.

Relaunch-safe: stable per-arm run dirs and periodic full-state checkpoints.
"""

from __future__ import annotations

import argparse
import json
import os
import time

ARMS = {
    "plain": {"register": False},
    "full": {
        "register": True,
        "shiftnet_warmup_steps": 400,
        "shiftnet_warmup_sigma": 1.5,
        "register_warmup_epochs": 30,
        "augment_dihedral": True,
    },
}
TEST_SEED_OFFSET = 7777  # the fresh test set's generator seed is seed + this


def score_test_set(model, scene_dirs, views: int, device) -> dict:
    """Per scene, shift-cPSNR of the plain forward (``plain_fwd``) and of x8
    dihedral TTA PCC-registered to the identity frame (``tta8``)."""
    from highresnet_tpu_torch.data import collate
    from highresnet_tpu_torch.eval.evaluator import Forward
    from highresnet_tpu_torch.exp import harness

    fwd_plain = Forward.plain(model, device, host=False)
    fwd_tta = Forward.tta(model, device, transforms=8, register=True, host=False)
    scores = {"plain_fwd": [], "tta8": []}
    for d in scene_dirs:
        s = harness.read_scene(d, views)
        batch = collate([s], views)
        score = harness.scene_scorer(s, device)
        scores["plain_fwd"].append(score(fwd_plain(batch.lrs, batch.alphas)[0]))
        scores["tta8"].append(score(fwd_tta(batch.lrs, batch.alphas)[0]))
    return scores


def main(argv=None):
    from highresnet_tpu_torch.exp.harness import default_out, default_root

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=default_root("hrn_flagship_data"))
    ap.add_argument("--test-root", default=default_root("hrn_flagship_test"))
    ap.add_argument("--scenes-per-channel", type=int, default=150)
    ap.add_argument("--test-scenes-per-channel", type=int, default=100)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--lr-size", type=int, default=48)
    ap.add_argument("--detail", type=float, default=0.5)
    ap.add_argument("--sigma", type=float, default=1.25,
                    help="per-scene Gaussian HR offset std (px) — the "
                    "structured misalignment model REGISTER_ABLATION uses")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--patch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=7e-4)
    ap.add_argument("--seed", type=int, default=0, help="the datasets' generator seed")
    ap.add_argument("--train-seed", type=int, default=None,
                    help="training.seed alone (default: the config's)")
    ap.add_argument("--val-proportion", type=float, default=0.1)
    ap.add_argument("--early-stop-patience", type=int, default=0)
    ap.add_argument("--regen", action="store_true")
    ap.add_argument("--out", default=default_out("FLAGSHIP_RECIPE.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from highresnet_tpu_torch.config import load_config
    from highresnet_tpu_torch.data import discover_scenes
    from highresnet_tpu_torch.exp import harness
    from highresnet_tpu_torch.runtime import setup_device
    from highresnet_tpu_torch.train.loop import train_and_get_best_model

    device = setup_device(args.device)
    t_start = time.time()

    # --- datasets: train root + FRESH test root (disjoint generator seed) --
    # only the TRAIN root gets the decode-free pack cache (the test root is
    # read once per arm, not every epoch)
    for root, spc, seed, pack in (
        (args.root, args.scenes_per_channel, args.seed, True),
        (args.test_root, args.test_scenes_per_channel, args.seed + TEST_SEED_OFFSET, False),
    ):
        harness.ensure_dataset(
            root,
            scenes_per_channel=spc,
            views=args.views,
            lr_size=args.lr_size,
            seed=seed,
            detail=args.detail,
            hr_shift_sigma=args.sigma,
            regen=args.regen,
            pack=pack,
        )

    test_scenes = discover_scenes(os.path.join(args.test_root, "train"))

    shared = {
        "num_epochs": args.epochs,
        "batch_size": args.batch,
        "n_views": args.views,
        "min_L": args.views,
        "patch_size": args.patch,
        "register_size": 2 * args.patch,
        "val_proportion": args.val_proportion,
        "eval_batch_size": 4,
        "checkpoint_every": 25,
        "lr": args.lr,
        "early_stop_patience": args.early_stop_patience,
        "data_parallel": False,
    }
    given, ckpt_suffix = {}, ""  # protocol keys and run-dir suffix of --train-seed
    if args.train_seed is not None:
        given, ckpt_suffix = {"train_seed": args.train_seed}, f"_train_seed{args.train_seed}"
        shared["seed"] = args.train_seed

    results = {}
    for arm, overrides in ARMS.items():
        config = load_config(
            overrides={
                "paths": {
                    "prefix": args.root,
                    "checkpoint_dir": os.path.join(args.root, f"ckpt_{arm}{ckpt_suffix}"),
                    "tb_log_file_dir": "",
                },
                "training": {**shared, **overrides},
            }
        )
        t0 = time.time()
        out = train_and_get_best_model(
            config, run_dir=os.path.join(args.root, f"ckpt_{arm}{ckpt_suffix}", "run"),
            device=device,
        )
        train_s = time.time() - t0
        print(f"[{arm}] trained in {train_s:.0f}s; best={out['best_score']:.3f}", flush=True)

        model = harness.model_from_params(config, out["params"]["hrnet"], device)
        scores = score_test_set(model, test_scenes, args.views, device)
        results[arm] = {
            "train_seconds": round(train_s, 1),
            "best_val_score": float(out["best_score"]),
            "best_epoch": int(out["best_epoch"]),
            "val_history": [[int(e), round(float(v), 4)] for e, v in out["val_history"]],
            "mean_shift_cpsnr": {k: float(np.mean(v)) for k, v in scores.items()},
            "per_scene_shift_cpsnr": {
                k: [round(x, 4) for x in v] for k, v in scores.items()
            },
        }
        for k in scores:
            print(f"[{arm}/{k}] test shift_cPSNR={np.mean(scores[k]):.3f}", flush=True)

    p, f = results["plain"]["per_scene_shift_cpsnr"], results["full"]["per_scene_shift_cpsnr"]
    report = {
        "what": (
            "Flagship recipe composition: reference-default training (plain) "
            "vs this framework's full recipe (registered loss + warm-start + "
            "curriculum + D4 augmentation), each scored plain and with x8 "
            "registered TTA on a fresh test set"
        ),
        "protocol": {
            "train_scenes": 2 * args.scenes_per_channel,
            "fresh_test_scenes": len(test_scenes),
            "views": args.views,
            "lr_size": args.lr_size,
            "hr_shift_sigma_px": args.sigma,
            "detail": args.detail,
            "epochs": args.epochs,
            "batch": args.batch,
            "lr": args.lr,
            "seed": args.seed,
            **given,
            "device": harness.device_label(device),
        },
        "arms": results,
        "comparisons": {
            "headline_full_tta_vs_plain": harness.paired_stats(f["tta8"], p["plain_fwd"]),
            "recipe_only_full_vs_plain": harness.paired_stats(f["plain_fwd"], p["plain_fwd"]),
            "tta_on_full": harness.paired_stats(f["tta8"], f["plain_fwd"]),
            "tta_on_plain": harness.paired_stats(p["tta8"], p["plain_fwd"]),
        },
    }
    harness.write_json(args.out, report)
    print(json.dumps(report["comparisons"], indent=2))
    print(f"[flagship_recipe] wall {time.time() - t_start:.1f} s (data, both arms, scoring)",
          flush=True)
    return report


if __name__ == "__main__":
    main()
