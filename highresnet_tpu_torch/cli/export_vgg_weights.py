"""Convert torchvision VGG19 weights to the .npz the port's extractor loads.

Usage:
    python -m highresnet_tpu_torch.cli.export_vgg_weights \
        --torch-weights vgg19.pth --out vgg19_conv_layers.npz [--device cuda]

The port's counterpart of ``highresnet_tpu.cli.export_vgg_weights``: the
input is a torch vgg19 state dict (``features.*`` tensors, as torchvision
saves it; read with ``weights_only=True``, so a pickled model object is
refused). The conv-stack tensors go to the .npz, which is then loaded back
through ``models.vgg.VGGFeatureExtractor`` on ``--device`` and must give
the same taps as the state dict itself.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--torch-weights", required=True, help="torch vgg19 state dict (.pth)")
    parser.add_argument("--out", default="vgg19_conv_layers.npz")
    parser.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = parser.parse_args(argv)

    import torch

    from highresnet_tpu_torch.models.vgg import VGGFeatureExtractor
    from highresnet_tpu_torch.runtime import setup_device

    device = setup_device(args.device)
    state = torch.load(args.torch_weights, map_location="cpu", weights_only=True)
    arrays = {k: v.numpy() for k, v in state.items() if "features" in k or k[0].isdigit()}
    if not arrays:
        raise SystemExit("no conv-stack tensors found in the checkpoint")
    np.savez(args.out, **arrays)
    print(f"wrote {len(arrays)} tensors to {args.out}")

    # round trip: the .npz and the state dict give the same taps
    probe = np.random.default_rng(0).random((64, 64), dtype=np.float32)
    taps = VGGFeatureExtractor(weights_path=args.out, device=device)(probe)
    want = VGGFeatureExtractor(weights_path=args.torch_weights, device=device)(probe)
    for name, tap in taps.items():
        if not torch.equal(tap, want[name]):
            raise SystemExit(f"tap {name} of {args.out} differs from the state dict's")
    print("loaded OK; tap shapes:", {k: tuple(v.shape) for k, v in taps.items()})
    return taps


if __name__ == "__main__":
    main()
