"""Drive the shipped flagship configs and assemble FLAGSHIP_CONFIG_DRIVE.json.

With ``--drive`` (``drive``; ``run_flagship_config.sh`` is this call), first
runs the arc of ``scripts/run_flagship_config.sh`` in this process, without
the TPU supervisor: ``materialize``, the four arms through the port's
``cli.train``, and the three ``cli.predict`` legs, where the control and the
recommended endpoint (ft_varl) run with RuntimeWarning as an error and the
stage-1-only checkpoint may warn. Then, or alone on an existing root,
scores the four config-surface arms (control / flagship / flagship_ft_rp /
flagship_ft_varl — all trained via ``cli.train --config ...``) on the SAME
val scenes through the package eval API, paired per scene:

  - plain forward for every arm, x8 registered TTA for the recipe arms
    (the shipped ``cli.predict --tta 8`` path);
  - a view-count sweep (top_k in {1,2,4,8,16}) of the arc endpoints,
    recording mean shift_cPSNR and peak out-of-[0,1] overflow per L;
  - a RuntimeWarning audit over the entire scoring pass (a normal
    train->predict flow must emit ZERO RuntimeWarnings).

    python -m highresnet_tpu_torch.examples.flagship_config_report [--drive] \
        [--root <tmp>/hrn_flagship_cfg] [--out build/examples/FLAGSHIP_CONFIG_DRIVE.json] \
        [--device cuda]

``materialize`` writes the dataset and the four run configs; the run dirs
are ``<root>/ckpt/<arm>``.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings

ARMS = {  # arm -> (materialized config, scored under x8 TTA too)
    "control": ("control_run.json", False),
    "flagship": ("flagship_run.json", True),
    "ft_rp": ("ft_rp_run.json", False),
    "ft_varl": ("ft_varl_run.json", True),
}
# cli.predict's legs of the arc: arm, extra flags, RuntimeWarning an error
PREDICT_LEGS = (
    ("control", [], True),
    ("flagship", ["--tta", "8"], False),  # stage 1 alone may leave [0, 1]
    ("ft_varl", ["--tta", "8"], True),
)
RECIPE_KNOBS = ("shiftnet_warmup_steps", "shiftnet_warmup_sigma", "register_warmup_epochs",
                "warp_int_range")


def _merge(base: dict, over: dict) -> dict:
    for k, v in over.items():
        base[k] = _merge(base.get(k, {}), v) if isinstance(v, dict) else v
    return base


def materialize(root: str, configs_dir: str = "configs", scenes_per_channel: int = 150,
                lr_size: int = 48, overrides: dict | None = None,
                warmup_steps: int | None = None) -> None:
    """The FLAGSHIP_RECIPE.json protocol's dataset at ``root`` (16 views,
    detail 0.5, per-scene Gaussian HR offsets sigma 1.25 px, seed 0) and
    the run configs: the shipped configs with paths pointed at ``root``,
    control = the recipe knobs removed, each fine-tune stage initialised
    from the stage before it; ``overrides`` is merged into every config and
    ``warmup_steps`` (None: the config's) sets the flagship stage's ShiftNet
    warm-start."""
    from highresnet_tpu_torch.data.synth import make_synthetic_dataset, synthetic_dataset_complete

    if not synthetic_dataset_complete(root):
        make_synthetic_dataset(
            root, n_scenes_per_channel=scenes_per_channel, n_views=16, lr_size=lr_size, seed=0,
            detail=0.5, hr_shift_sigma=1.25,
        )
    os.makedirs(os.path.join(root, "ckpt"), exist_ok=True)
    stages = (
        ("flagship.json", "control_run.json", None, True),
        ("flagship.json", "flagship_run.json", None, False),
        ("flagship_ft_rp.json", "ft_rp_run.json", "flagship", False),
        ("flagship_ft_varl.json", "ft_varl_run.json", "ft_rp", False),
    )
    for src, dst, init_from, strip_recipe in stages:
        with open(os.path.join(configs_dir, src)) as f:
            cfg = json.load(f)
        cfg["paths"]["prefix"] = root
        cfg["paths"]["checkpoint_dir"] = os.path.join(root, "ckpt")
        t = cfg["training"]
        if init_from is not None:
            t["init_params_from"] = os.path.join(root, "ckpt", init_from)
        elif warmup_steps is not None and not strip_recipe:
            t["shiftnet_warmup_steps"] = warmup_steps
        if strip_recipe:
            t["register"] = False
            t["augment_dihedral"] = False
            for k in RECIPE_KNOBS:
                t.pop(k, None)
        _merge(cfg, json.loads(json.dumps(overrides or {})))
        with open(os.path.join(root, dst), "w") as f:
            json.dump(cfg, f, indent=2)


def drive(root: str, device: str = "cuda", out: str | None = None, configs_dir: str = "configs",
          scenes_per_channel: int = 150, lr_size: int = 48, overrides: dict | None = None,
          warmup_steps: int | None = None, sweep_views=(1, 2, 4, 8, 16)) -> dict:
    """The whole arc: ``materialize``, the four arms through ``cli.train``,
    ``PREDICT_LEGS`` through ``cli.predict`` (a RuntimeWarning raises where
    the leg says so, as ``python -W error::RuntimeWarning`` would), then
    ``report``. The defaults are the protocol; smaller sizes serve smoke
    runs."""
    from highresnet_tpu_torch.cli import predict, train
    from highresnet_tpu_torch.exp.harness import default_out
    from highresnet_tpu_torch.runtime import setup_device

    device = str(setup_device(device))
    materialize(root, configs_dir, scenes_per_channel, lr_size, overrides, warmup_steps)
    for name, (cfg_name, _) in ARMS.items():
        train.main(["--config", os.path.join(root, cfg_name), "--run-dir",
                    os.path.join(root, "ckpt", name), "--device", device])
    for name, extra, strict in PREDICT_LEGS:
        with warnings.catch_warnings():
            if strict:
                warnings.simplefilter("error", RuntimeWarning)
            predict.main(["--config", os.path.join(root, ARMS[name][0]), "--checkpoint",
                          os.path.join(root, "ckpt", name), *extra, "--splits", "val",
                          "--device", device])
    return report(root, out or default_out("FLAGSHIP_CONFIG_DRIVE.json"), sweep_views, device)


def main(argv=None):
    from highresnet_tpu_torch.exp.harness import default_out, default_root

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=default_root("hrn_flagship_cfg"))
    ap.add_argument("--out", default=default_out("FLAGSHIP_CONFIG_DRIVE.json"))
    ap.add_argument("--sweep-views", type=int, nargs="*", default=[1, 2, 4, 8, 16])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--drive", action="store_true",
                    help="first build the data and configs, train the four arms and run the "
                         "predict legs (drive)")
    args = ap.parse_args(argv)

    from highresnet_tpu_torch.runtime import setup_device

    device = setup_device(args.device)
    if args.drive:
        return drive(args.root, device, args.out, sweep_views=args.sweep_views)
    return report(args.root, args.out, args.sweep_views, device)


def report(root: str, out: str, sweep_views, device) -> dict:
    """Score the four trained arms under ``root`` and write the report to
    ``out``; ``device`` comes from ``runtime.setup_device``."""
    import numpy as np

    from highresnet_tpu_torch.config import load_config
    from highresnet_tpu_torch.data import discover_scenes, read_imageset
    from highresnet_tpu_torch.eval.evaluator import Model, evaluate, load_data
    from highresnet_tpu_torch.exp import harness

    results: dict = {"arms": {}, "views_sweep": {}}

    # Predict flows, warnings audited PER ARM. The recommended flows
    # (reference-default control; the ft_varl endpoint) must be
    # RuntimeWarning-silent. The stage-1-only flagship checkpoint may warn
    # on misaligned data (overflow without the range penalty): that count is
    # recorded as a finding, not a failure.
    for name, (cfg_name, tta) in ARMS.items():
        cfg_path = os.path.join(root, cfg_name)
        config = load_config(cfg_path)
        min_l = config["training"]["min_L"]
        _, val_ds, _, _ = load_data(cfg_path, top_k=-1)
        policy = config["training"].get("single_view_policy", "warn")
        model = Model(config, device=device)
        model.load_checkpoint(os.path.join(root, "ckpt", name))
        with warnings.catch_warnings(record=True) as w_arm:
            warnings.simplefilter("always")
            scores, _, _ = evaluate(
                model.forward, {"val": val_ds}, min_l=min_l,
                single_view_policy=policy,
            )
            entry = {"val_plain": scores}
            if tta:
                model.enable_tta(transforms=8)
                tta_scores, _, _ = evaluate(
                    model.forward, {"val": val_ds}, min_l=min_l,
                    single_view_policy=policy,
                )
                entry["val_tta8"] = tta_scores
        entry["runtime_warning_count"] = sum(
            1 for wm in w_arm if issubclass(wm.category, RuntimeWarning)
        )
        results["arms"][name] = entry
        print(f"[report] {name}: val plain mean "
              f"{np.mean(list(scores.values())):.4f} "
              f"({entry['runtime_warning_count']} RuntimeWarnings)", flush=True)

    # view-count sweep of the arc endpoints (plain forward), deliberately
    # off-distribution at low L: warnings here are counted per row, not
    # mixed into the normal-flow audit
    for name in ("flagship", "ft_varl"):
        cfg_path = os.path.join(root, ARMS[name][0])
        config = load_config(cfg_path)
        min_l = config["training"]["min_L"]
        model = Model(config, device=device)
        model.load_checkpoint(os.path.join(root, "ckpt", name))
        rows = []
        for k in sweep_views:
            _, val_ds, _, _ = load_data(cfg_path, top_k=k)
            overflow = []
            fwd = model.forward

            def probe(lrs, alphas):
                sr = fwd(lrs, alphas)
                overflow.append(max(0.0, float(np.max(sr) - 1.0), float(-np.min(sr))))
                return sr

            probe.device = fwd.device
            with warnings.catch_warnings(record=True) as w_sweep:
                warnings.simplefilter("always")
                # policy "model": raw model behavior at every L
                scores, _, _ = evaluate(
                    probe, {"val": val_ds}, min_l=min_l,
                    single_view_policy="model",
                )
            vals = [s for s in scores.values() if s is not None]
            rows.append({
                "views": k,
                "mean_shift_cpsnr": float(np.mean(vals)),
                "max_out_of_range": round(max(overflow), 4),
                "out_of_range_warnings": sum(
                    1 for wm in w_sweep
                    if issubclass(wm.category, RuntimeWarning)
                ),
            })
            print(f"[report] sweep {name} L={k}: {np.mean(vals):.4f}", flush=True)
        results["views_sweep"][name] = rows

    recommended_flow_warnings = {
        name: results["arms"][name]["runtime_warning_count"]
        for name in ("control", "ft_varl")
    }

    def pair(a: dict, b: dict):
        names = sorted(set(a) & set(b))
        return harness.paired_stats([a[n] for n in names], [b[n] for n in names])

    arms_r = results["arms"]
    ctl = arms_r["control"]["val_plain"]
    scenes = discover_scenes(os.path.join(root, "train"))
    doc = {
        "what": ("configs/flagship{,_ft_rp,_ft_varl}.json driven end-to-end "
                 "through the port's cli.train + cli.predict --tta 8, vs a "
                 "reference-default control on identical data (same val "
                 "scenes, paired)"),
        "protocol": {
            "train_scenes": len(scenes), "views": 16,
            "lr_size": int(read_imageset(scenes[0], top_k=1).lr.shape[-1]), "detail": 0.5,
            "hr_shift_sigma_px": 1.25, "seed": 0,
            "root": root,
        },
        "val_mean": {
            name: {
                mode: float(np.mean([v for v in sc.values() if v is not None]))
                for mode, sc in entry.items()
                if isinstance(sc, dict)
            }
            for name, entry in arms_r.items()
        },
        "comparisons": {
            "flagship_tta_vs_control": pair(arms_r["flagship"]["val_tta8"], ctl),
            "flagship_vs_control": pair(arms_r["flagship"]["val_plain"], ctl),
            "ft_rp_vs_flagship": pair(
                arms_r["ft_rp"]["val_plain"], arms_r["flagship"]["val_plain"]),
            "ft_varl_vs_flagship": pair(
                arms_r["ft_varl"]["val_plain"], arms_r["flagship"]["val_plain"]),
            "ft_varl_tta_vs_control": pair(arms_r["ft_varl"]["val_tta8"], ctl),
        },
        "views_sweep": results["views_sweep"],
        "runtime_warnings_recommended_flow": recommended_flow_warnings,
        "per_scene": arms_r,
    }
    harness.write_json(out, doc)
    print(f"[report] wrote {out}; recommended-flow RuntimeWarnings: "
          f"{recommended_flow_warnings}")
    return doc


if __name__ == "__main__":
    main()
