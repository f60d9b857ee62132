"""Evaluate HRNet (or RAMS, or TR-MISR) weights and/or produce a Kelvin submission archive.

Usage:
    python -m highresnet_tpu_torch.cli.predict --config configs/config.json \
        --checkpoint <run dir, HRNet.pth or a dir holding it> [more checkpoints] \
        [--tta 4|8] [--registered] [--no-ensemble-registration] [--device cuda] \
        [--submission out_dir] [--splits val test]

The flags of ``highresnet_tpu.cli.predict`` plus ``--device``. Under
``network.arch: "rams"`` the checkpoint is ``RAMS.pth``, served plain (no
``--tta``, ``--registered`` or ensembles); under ``network.arch: "trmisr"``
(``configs/trmisr.json``) it is ``TRNet.pth``, served every way. A JAX run
directory (Orbax ``best/``) gets its ``HRNet.pth`` and, for
``--registered``, its ``ShiftNet.pth`` from ``scripts/export_torch_weights.py``.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="configs/config.json")
    parser.add_argument(
        "--checkpoint",
        required=True,
        nargs="+",
        help="a run dir of the port's cli.train (best/HRNet.pth), HRNet.pth, or a dir "
        "holding it; pass several for HighRes-net+ ensemble inference (members are "
        "PCC-registered to the first checkpoint's output frame before averaging — list "
        "the strongest model first)",
    )
    parser.add_argument(
        "--no-ensemble-registration",
        action="store_true",
        help="ensemble only: average raw member outputs without aligning them first",
    )
    parser.add_argument(
        "--tta",
        type=int,
        default=0,
        choices=[0, 4, 8],
        help="geometric self-ensemble: average the model over 4 or 8 dihedral symmetries "
        "of the input (outputs are PCC-registered to the identity-transform frame before "
        "averaging; single checkpoint only; 8 requires square inputs)",
    )
    parser.add_argument("--submission", default=None, help="write submission zip here")
    parser.add_argument("--splits", nargs="*", default=["val"], choices=["train", "val", "test"])
    parser.add_argument("--top-k", type=int, default=-1)
    parser.add_argument(
        "--registered",
        action="store_true",
        help="score with ShiftNet+Lanczos registration before the shift search (loads "
        "best/ShiftNet.pth beside best/HRNet.pth; BASELINE config #2 protocol)",
    )
    parser.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = parser.parse_args(argv)
    if not os.path.isfile(args.config):
        parser.error(f"config file not found: {args.config}")

    if len(args.checkpoint) > 1:
        if args.registered:
            parser.error("--registered (ShiftNet-registered scoring) is not "
                         "supported with ensemble inference")
        if args.tta:
            parser.error("--tta is single-checkpoint only (see Model.enable_tta)")
    elif args.registered and args.tta:
        parser.error("--tta cannot be combined with --registered scoring")

    from highresnet_tpu_torch.config import load_config
    from highresnet_tpu_torch.eval.evaluator import Model, benchmark, evaluate, load_data
    from highresnet_tpu_torch.runtime import setup_device

    config = load_config(args.config)
    device = setup_device(args.device)
    train_ds, val_ds, test_ds, baseline = load_data(args.config, top_k=args.top_k)
    model = Model(config, device=device)
    if len(args.checkpoint) > 1:
        model.load_ensemble(args.checkpoint, register=not args.no_ensemble_registration)
    elif args.registered:
        model.load_checkpoint_with_shiftnet(args.checkpoint[0])
    else:
        model.load_checkpoint(args.checkpoint[0])
        if args.tta:
            model.enable_tta(transforms=args.tta)

    datasets = {"train": train_ds, "val": val_ds, "test": test_ds}
    selected = {s: datasets[s] for s in args.splits}
    scores, clearances, part = evaluate(
        model.forward,
        selected,
        min_l=config["training"]["min_L"],
        registration=model.registration if args.registered else None,
        register_size=config["training"].get("register_size", 128),
        single_view_policy=config["training"].get("single_view_policy", "warn"),
    )
    table = benchmark(baseline, scores, part, clearances)
    print(table)

    if args.submission:
        archive = model.generate_submission_file(test_ds, out=args.submission)
        print(f"submission written: {archive}")
    return table


if __name__ == "__main__":
    main()
