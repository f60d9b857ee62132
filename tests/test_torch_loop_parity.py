"""The port's training loop against the JAX package's, over three epochs.

``highresnet_tpu.train.loop.train_and_get_best_model`` and the port's
``train_and_get_best_model(device="cpu")`` run side by side from the same
starting weights on the same tiny misaligned synthetic set:

- the start: a JAX donor trained for one epoch, its ``best/`` exported by
  ``scripts/export_torch_weights.py`` into ``HRNet.pth`` and
  ``ShiftNet.pth``; both loops take it through ``training.init_params_from``
  (JAX from Orbax, the port from the exported files) and then run a 2-step
  ShiftNet warm-start on the same injected crops and offsets (jax.random
  and torch.Generator cannot agree);
- the recipe: ``register_warmup_epochs`` 1 (epoch 1 unregistered, epochs 2-3
  registered), D4 augmentation, the range penalty, EMA with dual
  selection, a plateau schedule at patience 0, and a checkpoint every
  epoch; one process and no device mesh on either side (``data_parallel``
  off: a JAX mesh over the test suite's virtual CPU devices drops ragged
  batches); ShiftNet's dropout is off on both sides (hazard H3);
- held per epoch: the mean train loss, the selection score and both EMA
  and raw val scores, and the LR the schedule sets; then the best epoch
  and the HRNet parameters after epoch 3.

The reference is JAX's loop in float64 (``test_torch_train.jax_float64``).
From the port's init the warm-start and the registered epochs amplify f32
rounding: a pair warped in f32 by either package sits an ulp from the
other's, ReLU inputs within rounding of zero pass it on, and Adam's
lr·g/(|g| + eps) turns small gradients of either sign into steps of lr.
Every f32 run, JAX's own included, leaves the float64 one by far more than
1e-5 by epoch 3. So:

- ``test_loop_in_float64_matches_jax_in_float64``: both packages in float64
  at ``LR_WIDE`` 3.5e-3, where the f32 runs parted in epoch 3 (ShiftNet
  leaves the ±3 px warp window, the loss jumps from -17 to -9 and a one-ulp
  nudge of the start moves it by 0.5). The plateau cuts the LR after
  epochs 2 and 3. Every epoch's numbers and the final parameters within
  ``F64_RTOL``; the LRs, the best epoch and the val history equal.
- ``test_loop_matches_jax_over_three_epochs``: the port in f32 against JAX
  in float64 at configs/config.json's lr 7e-4. Tolerances, fixed before the
  test first ran: epoch 1 within rtol 1e-4; epochs 2-3 and the final
  parameters (per tensor, relative L2) within the larger of rtol 1e-4 and
  ``NOISE_FACTOR`` 4 times the noise floor measured in the same call
  (hazard H9), the larger of two: the port's f32 run against itself started
  from weights one float32 ulp away, and JAX's f32 run against its float64
  run; the best epoch and the LRs equal.

The harness (the donor, ``_run``, the recorded quantities) is
``_loop_harness.py``, shared with ``test_torch_loop_options.py``.
"""

from pathlib import Path

import numpy as np
import torch

from _loop_harness import (  # noqa: F401  (donor, few_threads: fixtures)
    EPOCHS,
    F64_RTOL,
    QUANTITIES,
    _rel,
    _run,
    donor,
    few_threads,
)

RTOL = 1e-4
NOISE_FACTOR = 4
LR_WIDE = 3.5e-3


def _nudged_copy(donor_dir, out_dir):
    """``donor_dir``'s exported best/ with every float moved one ulp up."""
    best = Path(out_dir) / "best"
    best.mkdir(parents=True)
    for name in ("HRNet.pth", "ShiftNet.pth"):
        state = torch.load(Path(donor_dir) / "best" / name, weights_only=True)
        torch.save({k: torch.nextafter(v, torch.full_like(v, np.inf)) if v.is_floating_point()
                    else v for k, v in state.items()}, best / name)
    return str(out_dir)


def _assert_recipe_ran(want, got):
    """Epoch 1 unregistered, epochs 2-3 registered, the same step counts and LRs."""
    assert len(want) == len(got) == EPOCHS
    assert want[0]["shift"] == got[0]["shift"] == 0.0
    assert all(e["shift"] > 0 for e in want[1:] + got[1:])
    assert [e["steps"] for e in got] == [e["steps"] for e in want]
    assert [e["lr"] for e in got] == [e["lr"] for e in want]


def test_loop_in_float64_matches_jax_in_float64(donor, monkeypatch):
    want, jax_out = _run(donor, monkeypatch, "jax", "jax64", float64=True, lr=LR_WIDE)
    got, port_out = _run(donor, monkeypatch, "port", "port64", float64=True, lr=LR_WIDE)
    _assert_recipe_ran(want, got)
    assert [e["lr"] for e in want] == [LR_WIDE, LR_WIDE / 2, LR_WIDE / 4]  # two plateau cuts
    for epoch, (w, g) in enumerate(zip(want, got), start=1):
        for q in QUANTITIES:
            assert abs(g[q] - w[q]) <= F64_RTOL * abs(w[q]), (epoch, q, g[q], w[q])
    assert port_out["best_epoch"] == jax_out["best_epoch"]
    assert [e for e, _ in port_out["val_history"]] == [e for e, _ in jax_out["val_history"]]
    for (_, g), (_, w) in zip(port_out["val_history"], jax_out["val_history"]):
        assert abs(g - w) <= F64_RTOL * abs(w), (g, w)
    for k, w in want[-1]["hrnet"].items():
        assert _rel(got[-1]["hrnet"][k], w) <= F64_RTOL, k


def _within(got, want, noise, first_epoch):
    tol = RTOL * abs(want)
    return abs(got - want) <= (tol if first_epoch else max(tol, NOISE_FACTOR * noise))


def test_loop_matches_jax_over_three_epochs(donor, monkeypatch):
    want, jax_out = _run(donor, monkeypatch, "jax", "jax64_config_lr", float64=True)
    jax32, _ = _run(donor, monkeypatch, "jax", "jax32_config_lr")
    got, port_out = _run(donor, monkeypatch, "port", "port32_config_lr")
    nudged = _nudged_copy(donor["run_dir"], donor["tmp"] / "nudged")
    noise, _ = _run(donor, monkeypatch, "port", "nudged_config_lr", init_params_from=nudged)

    _assert_recipe_ran(want, got)
    for epoch, (w, g, n, j) in enumerate(zip(want, got, noise, jax32), start=1):
        for q in QUANTITIES:
            floor = max(abs(n[q] - g[q]), abs(j[q] - w[q]))
            assert _within(g[q], w[q], floor, epoch == 1), (epoch, q, g[q], w[q], n[q], j[q])
    assert port_out["best_epoch"] == jax_out["best_epoch"]
    assert [e for e, _ in port_out["val_history"]] == [e for e, _ in jax_out["val_history"]]
    final, final_noise, final_jax32 = got[-1]["hrnet"], noise[-1]["hrnet"], jax32[-1]["hrnet"]
    for k, w in want[-1]["hrnet"].items():
        err = _rel(final[k], w)
        floor = max(_rel(final_noise[k], final[k]), _rel(final_jax32[k], w))
        assert err <= max(RTOL, NOISE_FACTOR * floor), (k, err, floor)
