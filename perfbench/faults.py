"""Faults planted in the program under test, to show that the check
catches them (``calibrate.py --fault``, ``tests/test_perfbench_runs.py``):

- ``unchanged``: the train step returns its state as it got it;
- ``half_batch``: the train step sees only the first half of each batch,
  so its mean is over the rest;
- ``altered``: the serving forwards (plain and TTA) return one scene's SR
  flipped upside down, an answer altered where it is produced.
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def plant(name: str):
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    import highresnet_tpu_torch.train.step as step_module
    from highresnet_tpu_torch.eval import evaluator

    build = step_module.build_train_step
    forwards = {cls: cls.__call__ for cls in (evaluator._Forward, evaluator._TTAForward)}

    def broken_build(config, layout=None):
        step = build(config, layout)

        def broken(state, lrs, alphas, hrs, hr_maps):
            if name == "unchanged":
                zero = lrs.new_zeros(())
                return state, {k: zero for k in
                               ("loss", "mean_abs_shift", "max_abs_shift", "grad_norm")}
            h = lrs.shape[0] // 2
            return step(state, lrs[:h], alphas[:h], hrs[:h], hr_maps[:h])
        return broken

    def broken_forward(cls):
        def forward(self, lrs, alphas):
            out = forwards[cls](self, lrs, alphas)
            out[0] = out[0][::-1].copy()
            return out
        return forward

    try:
        if name == "altered":
            for cls in forwards:
                cls.__call__ = broken_forward(cls)
        else:
            step_module.build_train_step = broken_build
        yield
    finally:
        step_module.build_train_step = build
        for cls, forward in forwards.items():
            cls.__call__ = forward
