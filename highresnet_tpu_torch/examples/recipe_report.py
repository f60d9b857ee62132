"""Merge identical-protocol quality_experiment arms into one report.

All arms must come from the SAME dataset, split and training protocol
(quality_experiment records the protocol; this script refuses to compare
arms whose protocols differ on anything but the recipe knobs under test —
the ADVICE.md round-2 lesson: never conflate protocol differences with the
effect being measured).

    python -m highresnet_tpu_torch.examples.recipe_report --baseline RECIPE_BASELINE.json \
        --candidate RECIPE_AUG.json RECIPE_EMA.json [--out build/examples/RECIPE_REPORT.json]

Host only: it reads the arms' reports (the JAX package's or the port's,
whose schema is the same) and runs nothing on a device.
"""

from __future__ import annotations

import argparse
import json
import os

# knobs an arm is ALLOWED to differ on — everything else must match
RECIPE_KEYS = {
    "ema_decay",
    "augment_dihedral",
    "grad_clip_norm",
    "variable_views_p",
    "range_penalty",
    "init_params_from",
    "val_views",
    "train_seconds",
    "device",
}

# protocol keys added after some reports were generated: a missing key in an
# older report means its documented default, not a mismatch
PROTOCOL_DEFAULTS = {
    "early_stop_patience": 0,
    "lr_decay": 0.97,
    "variable_views_p": 0.0,
    "range_penalty": 0.0,
    "init_params_from": "",
    "val_views": [],
}


def compare(base, cand, label):
    """One candidate-vs-baseline block; raises on protocol mismatch."""
    from highresnet_tpu_torch.exp.harness import paired_t

    bp, cp = dict(base["protocol"]), dict(cand["protocol"])
    mismatched = {
        k
        for k in (set(bp) | set(cp)) - RECIPE_KEYS
        if bp.get(k, PROTOCOL_DEFAULTS.get(k)) != cp.get(k, PROTOCOL_DEFAULTS.get(k))
    }
    if mismatched:
        raise SystemExit(
            f"{label}: protocols differ beyond the recipe knobs: "
            f"{sorted(mismatched)} — rerun the arms under one shared protocol"
        )

    b_rows = {r["scene"]: r for r in base["per_scene"]}
    c_rows = {r["scene"]: r for r in cand["per_scene"]}
    if set(b_rows) != set(c_rows):
        raise SystemExit(f"{label}: arms scored different validation scenes")

    scenes = sorted(b_rows)
    deltas = [c_rows[s]["mfsr"] - b_rows[s]["mfsr"] for s in scenes]
    mean_delta = sum(deltas) / len(deltas)
    wins = sum(d > 0 for d in deltas)
    t = paired_t(deltas)
    return {
        "recipe": {k: cp.get(k) for k in sorted(RECIPE_KEYS - {"train_seconds", "device"})},
        "mean_shift_cpsnr": cand["val_mean_shift_cpsnr"]["mfsr"],
        "minus_baseline_db": round(mean_delta, 4),
        "scenes_where_candidate_wins": f"{wins}/{len(scenes)}",
        "paired_t": None if t is None else round(t, 3),
        "train_seconds": cp.get("train_seconds"),
        "per_scene_delta_db": {s: round(d, 4) for s, d in zip(scenes, deltas)},
    }


def main(argv=None):
    from highresnet_tpu_torch.exp.harness import default_out, write_json

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True)
    ap.add_argument("--candidate", required=True, nargs="+")
    ap.add_argument("--out", default=default_out("RECIPE_REPORT.json"))
    ap.add_argument(
        "--note", action="append", default=[],
        help="free-text annotation(s) carried into the report (interpretation "
        "context a bare number table would lose)",
    )
    args = ap.parse_args(argv)

    with open(args.baseline) as f:
        base = json.load(f)

    bp = dict(base["protocol"])
    report = {
        "what": "recipe comparison: each candidate vs the baseline arm, identical protocol/dataset/split",
        "protocol": {k: v for k, v in bp.items() if k not in RECIPE_KEYS},
        "baseline": {
            "recipe": {k: bp.get(k) for k in sorted(RECIPE_KEYS - {"train_seconds", "device"})},
            "mean_shift_cpsnr": base["val_mean_shift_cpsnr"]["mfsr"],
            "train_seconds": bp.get("train_seconds"),
        },
        "candidates": {},
    }
    if args.note:
        report["notes"] = args.note
    for path in args.candidate:
        with open(path) as f:
            cand = json.load(f)
        label = os.path.splitext(os.path.basename(path))[0]
        if label in report["candidates"]:
            raise SystemExit(
                f"duplicate candidate label {label!r} (same filename in two "
                "directories?) — rename one file so no arm is silently dropped"
            )
        report["candidates"][label] = compare(base, cand, label)

    write_json(args.out, report)
    slim = json.loads(json.dumps(report))
    for block in slim["candidates"].values():
        block.pop("per_scene_delta_db")
    print(json.dumps(slim, indent=2))
    return report


if __name__ == "__main__":
    main()
