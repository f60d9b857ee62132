"""Export a JAX run directory's best weights as HRNet.pth and ShiftNet.pth for the PyTorch port.

    python scripts/export_torch_weights.py --config configs/config.json --run-dir <run_dir>

Reads ``<run_dir>/best`` (Orbax, so this needs JAX and runs off the GPU
machine) with the network of ``--config`` and writes the reference
state-dict formats:

- ``HRNet.pth``, from ``highresnet_tpu.eval.evaluator.load_model``;
- ``ShiftNet.pth`` (parameters and BatchNorm statistics), from
  ``Model.load_checkpoint_with_shiftnet`` at the config's
  ``register_size``, when ``best/`` holds ShiftNet (every run of
  ``cli.train`` saves both; an HRNet-only ``best/`` gets ``HRNet.pth`` alone).

Both go to ``<run_dir>/best/``, where the port's ``cli.predict --checkpoint
<run_dir> [--registered]`` and ``training.init_params_from = <run_dir>``
read them. Orbax ignores the extra files in ``best/``.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _holds_shiftnet(best: str) -> bool:
    import orbax.checkpoint as ocp

    tree = ocp.StandardCheckpointer().metadata(best).item_metadata.tree
    return "shiftnet" in tree.get("params", {})


def main(argv=None) -> str:
    """Write the files; returns ``<run_dir>/best/HRNet.pth``."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default="configs/config.json")
    parser.add_argument("--run-dir", required=True, help="JAX run dir containing best/")
    args = parser.parse_args(argv)

    from highresnet_tpu.exp.harness import honor_platform_and_cache

    honor_platform_and_cache()

    import jax
    import torch

    from highresnet_tpu.config import load_config
    from highresnet_tpu.eval.evaluator import Model, load_model
    from highresnet_tpu_torch.models.convert import (
        SHIFTNET_NAME,
        WEIGHTS_NAME,
        hrnet_state_dict_from_flax,
        shiftnet_state_dict_from_flax,
    )

    config = load_config(args.config)
    _, params = load_model(config, args.run_dir)
    files = {WEIGHTS_NAME: hrnet_state_dict_from_flax(jax.device_get(params))}
    if _holds_shiftnet(os.path.join(os.path.abspath(args.run_dir), "best")):
        model = Model(config)
        model.load_checkpoint_with_shiftnet(args.run_dir)
        variables = jax.device_get(model.registration[1])
        files[SHIFTNET_NAME] = shiftnet_state_dict_from_flax(variables["params"],
                                                             variables["batch_stats"])
    best = os.path.join(args.run_dir, "best")
    for name, state_dict in files.items():
        path = os.path.join(best, name)
        torch.save(state_dict, path)
        print(f"wrote {path}")
    return os.path.join(best, WEIGHTS_NAME)


if __name__ == "__main__":
    main()
