"""Interactive serving with x8 registered TTA: one scene a call through
``Model.__call__``.

Set-up makes the weights and a pool of ``pool`` test scenes (``views``
views of ``lr_size`` px, between ``min_views`` and ``views`` real, no HR)
on the device from the seed, keeps them in host memory as ``ImageSet``s,
loads the weights through ``Model.set_params``, wraps the forward with
``Model.enable_tta(transforms, register=True)`` and warms up with two
scenes. A call hands the next scene to ``Model(imset)`` (collate to
``min_L``, the dihedral forwards, the phase-correlation alignment, the
mean, the SR back in host memory); its latency is the call's.

The check draws, from the seed, one served call of every pool scene and
holds its SR to the plain reference's TTA on the same scene and weights
(``sr_gap``, as the archive cell's).
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import compare, flops, synth, weights
from perfbench.reference import tta as ref_tta
from perfbench.reference.hrnet import HRNet as RefHRNet
from perfbench.reference.hrnet import param_spec
from perfbench.reference.ops import F32, TF32, Ops, no_tf32

E2E = {"tta8_p90_ms": "ms"}
TRACE_CALLS = 3


class Session:
    def __init__(self, cell, device: torch.device, seed: int, control: bool = False):
        p = cell.traffic
        self.cell, self.device, self.seed = cell, device, seed
        self.net = cell.config["network"]
        self.min_l = cell.config["training"]["min_L"]
        self.views, self.size, self.transforms = p["views"], p["lr_size"], p["transforms"]
        g = torch.Generator(device=device).manual_seed(seed)
        self.params = weights.make(param_spec(self.net), g, device)
        lrs, alphas, _, _ = synth.scenes(g, p["pool"], self.views, self.size, device,
                                         min_views=p["min_views"])
        real = alphas.sum(dim=1).long().tolist()
        lrs = lrs.cpu().numpy()
        from highresnet_tpu_torch.data.probav import ImageSet

        self.pool = [ImageSet(name=f"scene{j}", lr=lrs[j, :n], hr=None, hr_map=None,
                              clearances=np.ones(n, np.float32)) for j, n in enumerate(real)]
        self.model = None
        if control:
            ref = RefHRNet(self.net, Ops(TF32))

            def serve(imset):
                lr, alphas = self._batch(imset)
                with torch.inference_mode():
                    sr = ref_tta.tta(lambda x, a: ref(self.params, x, a), lr, alphas,
                                     self.transforms)
                return sr[0].cpu().numpy(), None
            self.serve = serve
        else:
            from highresnet_tpu_torch.config import load_config
            from highresnet_tpu_torch.eval.evaluator import Model

            self.model = Model(load_config(str(cell.config_path)), device)
            self.model.set_params(self.params)
            self.model.enable_tta(self.transforms, register=True)
            self.serve = self.model
        for j in range(2):
            self.serve(self.pool[j])
        self.outputs = []  # (pool index, SR) of every call

    def _batch(self, imset):
        """The scene collated to min_L views as the reference takes it."""
        n = len(imset.lr)
        lr = np.zeros((1, self.min_l, self.size, self.size), np.float32)
        lr[0, :min(n, self.min_l)] = imset.lr[:self.min_l]
        alphas = (np.arange(self.min_l) < n).astype(np.float32)[None]
        return (torch.as_tensor(lr, device=self.device),
                torch.as_tensor(alphas, device=self.device))

    def call(self) -> int:
        j = len(self.outputs) % len(self.pool)
        sr, _ = self.serve(self.pool[j])
        self.outputs.append((j, sr))
        return 1

    def e2e(self, items: int, seconds: float, latencies) -> dict:
        return {"tta8_p90_ms": 1e3 * float(np.percentile(latencies, 90))}

    def context(self) -> dict:
        f = self.transforms * flops.hrnet_forward_flops(self.net, 1, self.min_l, self.size)
        return {"flops_per_item": f, "conv_flops_per_item": f}

    def trace(self) -> int:
        return sum(self.call() for _ in range(TRACE_CALLS))

    def after_trace(self) -> dict:
        return {}

    def release(self) -> None:
        self.model = self.serve = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """sr_gap over one served call of each pool scene, drawn from the seed."""
        rng = np.random.default_rng(self.seed)
        served = {}
        for j, sr in self.outputs:
            served.setdefault(j, []).append(sr)
        no_tf32()
        ref = RefHRNet(self.net, Ops(F32))
        gap = 0.0
        for j in sorted(served):
            sr = served[j][rng.integers(len(served[j]))]
            lr, alphas = self._batch(self.pool[j])
            with torch.inference_mode():
                want = ref_tta.tta(lambda x, a: ref(self.params, x, a), lr, alphas,
                                   self.transforms)
            gap = max(gap, compare.image_gap(sr[None], want.cpu().numpy()))
        return {"sr_gap": gap}
