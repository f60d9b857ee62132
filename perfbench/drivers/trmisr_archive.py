"""Archive super-resolution with TR-MISR: closed-loop batches through ``Model.forward``.

Set-up makes TR-MISR's weights (``reference/trmisr.py``'s ``param_spec``)
and a pool of ``pool`` batches of ``batch`` scenes (``views`` views of
``lr_size`` px, between ``min_views`` and ``views`` of them real, so the
attention's key mask is at work) on the device from the seed, keeps the
batches in host memory, loads the weights through ``Model.set_params`` and
warms up with two calls. A call hands the next batch, as host numpy, to
``Model.forward`` (the plain ``Forward``: host to device, TR-MISR, device
to host) and keeps the SR it returns.

The check draws, from the seed, one served call of every pool batch and
holds its SR to the plain reference's forward on the same batch and
weights, computed a scene at a time (``sr_gap``: the worst scene's max
|SR - ref| over max |ref|). The control is the reference at TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import compare, synth, weights
from perfbench.flops_trmisr import attend_bytes, trmisr_forward_flops
from perfbench.reference.ops import F32, TF32, no_tf32
from perfbench.reference.trmisr import TRMISR, param_spec

E2E = {"archive_scenes_per_s": "scenes/s"}
TRACE_CALLS = 3
REF_SCENES = 1  # scenes a reference call: it fits beside what the program left


class Session:
    def __init__(self, cell, device: torch.device, seed: int, control: bool = False):
        p = cell.traffic
        self.cell, self.device, self.seed = cell, device, seed
        self.net = cell.config["network"]
        self.batch, self.views, self.size = p["batch"], p["views"], p["lr_size"]
        g = torch.Generator(device=device).manual_seed(seed)
        self.params = weights.make(param_spec(self.net), g, device)
        self.pool = []
        for _ in range(p["pool"]):
            lrs, alphas, _, _ = synth.scenes(g, self.batch, self.views, self.size, device,
                                             min_views=p["min_views"])
            self.pool.append((lrs.cpu().numpy(), alphas.cpu().numpy()))
        self.model = None
        if control:
            ref = TRMISR(self.net, TF32)

            def forward(lrs, alphas):
                with torch.inference_mode():
                    return ref(self.params, torch.as_tensor(lrs, device=device),
                               torch.as_tensor(alphas, device=device),
                               REF_SCENES).cpu().numpy()
            self.forward = forward
        else:
            from highresnet_tpu_torch.config import load_config
            from highresnet_tpu_torch.eval.evaluator import Model

            self.model = Model(load_config(str(cell.config_path)), device)
            self.model.set_params(self.params)
            self.forward = self.model.forward
        for _ in range(2):
            self.forward(*self.pool[0])
        self.outputs = []  # (pool index, SR) of every call

    def call(self) -> int:
        j = len(self.outputs) % len(self.pool)
        self.outputs.append((j, self.forward(*self.pool[j])))
        return self.batch

    def e2e(self, items: int, seconds: float, latencies) -> dict:
        return {"archive_scenes_per_s": items / seconds}

    def context(self) -> dict:
        shape = (self.net, 1, self.views, self.size)
        return {"flops_per_item": trmisr_forward_flops(*shape),
                "conv_flops_per_item": trmisr_forward_flops(*shape, conv=True),
                "attend_bytes_per_item": attend_bytes(*shape)}

    def trace(self) -> int:
        return sum(self.call() for _ in range(TRACE_CALLS))

    def after_trace(self) -> dict:
        return {}

    def release(self) -> None:
        self.model = self.forward = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """sr_gap over one served call of each pool batch, drawn from the seed."""
        rng = np.random.default_rng(self.seed)
        served = {}
        for j, sr in self.outputs:
            served.setdefault(j, []).append(sr)
        no_tf32()
        ref = TRMISR(self.net, F32)
        gap = 0.0
        for j in sorted(served):
            sr = served[j][rng.integers(len(served[j]))]
            lrs, alphas = self.pool[j]
            with torch.inference_mode():
                want = ref(self.params, torch.as_tensor(lrs, device=self.device),
                           torch.as_tensor(alphas, device=self.device), REF_SCENES).cpu().numpy()
            gap = max(gap, compare.image_gap(sr, want))
        return {"sr_gap": gap}
