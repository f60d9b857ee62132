"""Quality evidence: trained MFSR vs naive baselines on a validation split.

For each val scene, reports shift_cPSNR of:
  - the trained HRNet SR (all views),
  - the trained HRNet with a single view (MFSR benefit ablation),
  - bicubic 3x upsampling of the clearest LR view (no-learning baseline,
    JAX's cubic through ``ops/resize.py``).

    python -m highresnet_tpu_torch.examples.quality_report --data <root> \
        --checkpoint <run dir> [--config configs/config.json] [--device cuda]

The checkpoint is a run directory of the port's ``cli.train`` (its
``best/HRNet.pth``), ``HRNet.pth`` or a directory holding it.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--config", default=None)
    parser.add_argument("--views", type=int, default=8)
    parser.add_argument("--val-proportion", type=float, default=0.25)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import numpy as np

    from highresnet_tpu_torch.config import load_config
    from highresnet_tpu_torch.eval.evaluator import Forward, load_model
    from highresnet_tpu_torch.exp import harness
    from highresnet_tpu_torch.runtime import setup_device

    device = setup_device(args.device)
    config = load_config(args.config)
    fwd = Forward.plain(load_model(config, args.checkpoint, device), device, host=False)
    val = harness.held_out_scenes(args.data, args.val_proportion)
    rows = harness.mfsr_rows(fwd, val, args.views, device)

    print(f"{'scene':<12} {'MFSR':>8} {'1-view':>8} {'bicubic':>8}")
    for r in rows:
        print(f"{r['scene']:<12} {r['mfsr']:8.2f} {r['one_view']:8.2f} {r['bicubic']:8.2f}")
    arr = np.array([[r["mfsr"], r["one_view"], r["bicubic"]] for r in rows])
    print(f"{'mean':<12} {arr[:,0].mean():8.2f} {arr[:,1].mean():8.2f} {arr[:,2].mean():8.2f}")
    return rows


if __name__ == "__main__":
    main()
