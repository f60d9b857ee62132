"""Evaluate HRNet weights and/or produce a Kelvin submission archive.

Usage:
    python -m highresnet_tpu_torch.cli.predict --config configs/config.json \
        --checkpoint <HRNet.pth or a dir holding it> [--device cuda] \
        [--submission out_dir] [--splits val test]

A JAX run directory (Orbax ``best/``) gets its ``HRNet.pth`` from
``scripts/export_torch_weights.py``.
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
        help="HRNet.pth, or a directory holding it (one checkpoint; ensembles "
        "are not ported yet)",
    )
    parser.add_argument("--no-ensemble-registration", action="store_true",
                        help="ensemble only (not ported yet)")
    parser.add_argument("--tta", type=int, default=0, choices=[0, 4, 8],
                        help="geometric self-ensemble (not ported yet)")
    parser.add_argument("--submission", default=None, help="write submission zip here")
    parser.add_argument("--splits", nargs="*", default=["val"], choices=["train", "val", "test"])
    parser.add_argument("--top-k", type=int, default=-1)
    parser.add_argument("--registered", action="store_true",
                        help="ShiftNet-registered scoring (not ported yet)")
    parser.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = parser.parse_args(argv)
    if not os.path.isfile(args.config):
        parser.error(f"config file not found: {args.config}")

    from highresnet_tpu_torch.eval.evaluator import NOT_PORTED

    if len(args.checkpoint) > 1:
        parser.error(NOT_PORTED["ensemble"])
    if args.tta:
        parser.error(NOT_PORTED["tta"])
    if args.registered:
        parser.error(NOT_PORTED["registration"])

    from highresnet_tpu_torch.config import load_config
    from highresnet_tpu_torch.eval.evaluator import Model, benchmark, evaluate, load_data
    from highresnet_tpu_torch.runtime import setup_device

    config = load_config(args.config)
    device = setup_device(args.device)
    train_ds, val_ds, test_ds, baseline = load_data(args.config, top_k=args.top_k)
    model = Model(config, device=device)
    model.load_checkpoint(args.checkpoint[0])

    datasets = {"train": train_ds, "val": val_ds, "test": test_ds}
    selected = {s: datasets[s] for s in args.splits}
    scores, clearances, part = evaluate(
        model.forward,
        selected,
        min_l=config["training"]["min_L"],
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
