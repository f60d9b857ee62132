"""Evaluate a trained checkpoint — the `test_model.ipynb` capability.

Loads best weights from a run dir, scores train/val/test splits
(shift_cPSNR + ESA-ratio benchmark table), prints score statistics, and
optionally writes a Kelvin submission archive.

    python -m highresnet_tpu_torch.examples.test_model --config configs/config.json \
        --checkpoint <run dir> [--submission submission/] [--device cuda]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="configs/config.json")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--submission", default=None)
    parser.add_argument("--top-k", type=int, default=-1)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from highresnet_tpu_torch.config import load_config
    from highresnet_tpu_torch.eval.evaluator import Model, load_data
    from highresnet_tpu_torch.runtime import setup_device

    device = setup_device(args.device)
    config = load_config(args.config)
    train_ds, val_ds, test_ds, baseline = load_data(args.config, top_k=args.top_k)

    model = Model(config, device=device)
    model.load_checkpoint(args.checkpoint)
    results = model.evaluate(train_ds, val_ds, test_ds, baseline)
    print(results)
    print("\nscore stats by split (ESA/model, lower is better):")
    print(results.groupby("part")["score"].describe())

    if args.submission:
        archive = model.generate_submission_file(test_ds, out=args.submission)
        print(f"submission: {archive}")
    return results


if __name__ == "__main__":
    main()
