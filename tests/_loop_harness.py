"""The float64 harness that runs JAX's training loop beside the port's.

Shared by ``test_torch_loop_parity.py`` (the recipe's own keys) and
``test_torch_loop_options.py`` (grad clip, early stop, uncached val,
val_views). Both packages' ``train_and_get_best_model`` start from one JAX
donor on one tiny misaligned synthetic set:

- the donor: a JAX run trained for one epoch, its ``best/`` exported by
  ``scripts/export_torch_weights.py`` into ``HRNet.pth`` and
  ``ShiftNet.pth``; both loops take it through ``training.init_params_from``
  (JAX from Orbax, the port from the exported files) and then run a 2-step
  ShiftNet warm-start on the same injected crops and offsets (jax.random
  and torch.Generator cannot agree);
- the recipe (``CONFIG``): ``register_warmup_epochs`` 1, D4 augmentation,
  the range penalty, EMA with dual selection, a plateau schedule at
  patience 0, a checkpoint every epoch; one process and no device mesh on
  either side (``data_parallel`` off: a JAX mesh over the test suite's
  virtual CPU devices drops ragged batches); ShiftNet's dropout off on both
  sides (hazard H3);
- ``_run`` records each epoch (``_trace``): the mean train loss, each
  step's gradient norm, the selection score, the raw and EMA val scores,
  the LR the schedule sets and the HRNet after the epoch.

Import the fixtures (``donor``, ``few_threads``) into the test module.
"""

import copy
import importlib.util
import json
import os
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import highresnet_tpu.train.loop as jax_loop
import highresnet_tpu.train.setup as jax_setup
import highresnet_tpu_torch.train.loop as port_loop
import highresnet_tpu_torch.train.setup as port_setup
from highresnet_tpu.models.convert import hrnet_params_from_torch
from highresnet_tpu_torch.data import discover_scenes, make_synthetic_dataset, train_val_split
from highresnet_tpu_torch.train import pretrain as port_pretrain
from test_torch_train import jax_float64, port_float64, state_to_float64

REPO = Path(__file__).resolve().parents[1]
EPOCHS = 3
F64_RTOL = 1e-8
WARM_STEPS, WARM_BATCH = 2, 32  # the warm-start's steps; its batch is both packages' default
LR = 7e-4  # configs/config.json's
DONOR_LR = 1e-3
CONFIG = {
    "network": {
        "encoder": {"in_channels": 2, "num_layers": 1, "kernel_size": 3, "channel_size": 8},
        "recursive": {"alpha_residual": True, "in_channels": 8, "kernel_size": 3},
        "decoder": {
            "deconv": {"in_channels": 8, "kernel_size": 3, "stride": 3, "out_channels": 8},
            "final": {"in_channels": 8, "kernel_size": 1, "out_channels": 1},
        },
    },
    "training": {
        "batch_size": 2, "min_L": 4, "n_views": 4, "crop": 1, "lr": LR, "lr_step": 0,
        "lr_decay": 0.5, "beta": 50.0, "create_patches": True, "patch_size": 16,
        "register_size": 32, "val_proportion": 0.34, "lambda": 1e-6, "num_epochs": EPOCHS,
        "n_workers": 1, "seed": 0, "eval_batch_size": 2, "checkpoint_every": 1,
        "register": True, "register_warmup_epochs": 1, "augment_dihedral": True,
        "shiftnet_warmup_steps": WARM_STEPS, "shiftnet_warmup_sigma": 1.0,
        "range_penalty": 7.0, "ema_decay": 0.9, "data_parallel": False,
    },
    "paths": {"prefix": "", "checkpoint_dir": "", "tb_log_file_dir": ""},
}
QUANTITIES = ("loss", "val", "raw", "ema")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the suite runs files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _config(root, ckpt, **training):
    cfg = copy.deepcopy(CONFIG)
    cfg["training"].update(training)
    cfg["paths"].update(prefix=root, checkpoint_dir=ckpt)
    return cfg


def _export(cfg, tmp, run_dir):
    path = tmp / "donor.json"
    path.write_text(json.dumps(cfg))
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", REPO / "scripts" / "export_torch_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--config", str(path), "--run-dir", run_dir])


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_hrnet(state):
    return _flat(jax.device_get(state.params["hrnet"]))


def _port_params(hrnet_state_dict):
    """A port HRNet state dict as flat float64 arrays under JAX's names."""
    n_res = CONFIG["network"]["encoder"]["num_layers"]
    return _flat(hrnet_params_from_torch(
        {k: v.detach().double().clone() for k, v in hrnet_state_dict.items()},
        num_res_layers=n_res))


def _port_hrnet(state):
    return _port_params(state.hrnet.state_dict())


def _trace(monkeypatch, loop, hrnet_of):
    """Record each epoch of ``loop``: train loss, each step's gradient norm,
    the HRNet after the epoch, the selection score, the raw and EMA val
    scores, the new LR."""
    epochs = []
    real_epoch, real_dual, real_schedule = (loop.run_train_epoch, loop.dual_candidates,
                                            loop.ReduceLROnPlateau)

    def run_train_epoch(loader, state, step_fn, *args, **kwargs):
        grad_norms = []

        def step(state, *batch):
            state, metrics = step_fn(state, *batch)
            grad_norms.append(float(metrics["grad_norm"]))
            return state, metrics

        state, stats, n_steps = real_epoch(loader, state, step, *args, **kwargs)
        epochs.append({"loss": float(stats["train_loss"]), "steps": n_steps,
                       "grad_norms": grad_norms, "shift": float(stats["mean_abs_shift"]),
                       "hrnet": hrnet_of(state)})
        return state, stats, n_steps

    def dual_candidates(state, score, eval_raw):
        out = real_dual(state, score, eval_raw)
        epochs[-1].update(val=float(out[0]), raw=float(out[2]), ema=float(out[3]))
        return out

    class Schedule(real_schedule):
        def step(self, value):
            epochs[-1]["lr"] = super().step(value)
            return epochs[-1]["lr"]

    monkeypatch.setattr(loop, "run_train_epoch", run_train_epoch)
    monkeypatch.setattr(loop, "dual_candidates", dual_candidates)
    monkeypatch.setattr(loop, "ReduceLROnPlateau", Schedule)
    return epochs


def _inject_warmstart_draws(monkeypatch, idx, d):
    """Both warm-starts take crops ``idx`` and offsets ``d`` (dy, dx) at
    every step: JAX's draws replaced while its warm-start runs (sigma 1, so
    d = normal), the port's handed to its step."""
    real_jax = jax_setup.maybe_warmstart_shiftnet

    def jax_warmstart(*args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(idx))
            m.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(d))
            return real_jax(*args, **kwargs)

    real_step = port_pretrain.pretrain_step

    def port_step(shiftnet, opt, pool, _idx, _d, *rest):
        return real_step(shiftnet, opt, pool, torch.from_numpy(idx).to(pool.device),
                         torch.from_numpy(d).to(pool.device), *rest)

    monkeypatch.setattr(jax_setup, "maybe_warmstart_shiftnet", jax_warmstart)
    monkeypatch.setattr(port_pretrain, "pretrain_step", port_step)


def _dropout_off(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    real = port_setup.create_train_state

    def create_train_state(*args, **kwargs):
        state = real(*args, **kwargs)
        state.shiftnet.dropout = 0.0
        return state

    monkeypatch.setattr(port_setup, "create_train_state", create_train_state)


@pytest.fixture(scope="module")
def donor(tmp_path_factory):
    """The dataset, the exported JAX donor run and the warm-start's draws."""
    tmp = tmp_path_factory.mktemp("loop_parity")
    root = make_synthetic_dataset(str(tmp / "data"), n_scenes_per_channel=3, n_views=5,
                                  lr_size=24, seed=0, splits=("train",), hr_shift_sigma=1.25)
    ckpt = str(tmp / "ckpt")
    donor_cfg = _config(root, ckpt, num_epochs=1, lr=DONOR_LR, register=False,
                        shiftnet_warmup_steps=0, augment_dihedral=False, ema_decay=0.0)
    run_dir = str(tmp / "donor")
    jax_loop.train_and_get_best_model(donor_cfg, run_dir=run_dir)
    _export(donor_cfg, tmp, run_dir)
    assert {"HRNet.pth", "ShiftNet.pth"} <= set(os.listdir(os.path.join(run_dir, "best")))
    t = CONFIG["training"]
    train_list, _ = train_val_split(discover_scenes(f"{root}/train"), t["val_proportion"], seed=1)
    rng = np.random.default_rng(11)
    idx = rng.integers(0, len(train_list), WARM_BATCH).astype(np.int32)
    d = rng.uniform(-2.0, 2.0, (WARM_BATCH, 2)).astype(np.float32)  # inside the ±3 px window
    return {"root": root, "ckpt": ckpt, "run_dir": run_dir, "tmp": tmp, "idx": idx, "d": d}


def _f64_tree(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _run(donor, monkeypatch, package, name, float64=False, **training):
    """One loop of ``package`` ("jax" or "port") from the donor into the run
    directory ``name`` (a second call with the same name resumes it);
    returns its per-epoch trace and its result."""
    start = training.pop("init_params_from", donor["run_dir"])
    cfg = _config(donor["root"], donor["ckpt"], init_params_from=start, **training)
    run_dir = str(donor["tmp"] / name)
    with monkeypatch.context() as m:
        _dropout_off(m)
        _inject_warmstart_draws(m, donor["idx"], donor["d"])
        if package == "jax":
            trace = _trace(m, jax_loop, _jax_hrnet)
            if not float64:
                return trace, jax_loop.train_and_get_best_model(cfg, run_dir=run_dir)
            warmstart = jax_setup.maybe_warmstart_shiftnet
            m.setattr(jax_setup, "maybe_warmstart_shiftnet",
                      lambda state, *a, **k: warmstart(_f64_tree(state), *a, **k))
            with jax_float64(m):
                return trace, jax_loop.train_and_get_best_model(cfg, run_dir=run_dir)
        trace = _trace(m, port_loop, _port_hrnet)
        if float64:
            create = port_setup.create_train_state
            m.setattr(port_setup, "create_train_state",
                      lambda *a, **k: state_to_float64(create(*a, **k)))
            port_float64(m)
        return trace, port_loop.train_and_get_best_model(cfg, run_dir=run_dir, device="cpu")


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
