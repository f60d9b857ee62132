"""Configuration: JSON files with the reference's schema, plus defaults.

The port's own copy of ``highresnet_tpu/config.py``, imports pointed at
``highresnet_tpu_torch``; the port imports nothing of the JAX package.

Public-API compatibility: configs/config.json here mirrors the key layout
of the reference's config/config.json (paths / network / training) so
existing configs drop in unchanged (BASELINE.json requires API compat).
"""

from __future__ import annotations

import copy
import json
import os
import warnings
from typing import Any, Dict

DEFAULT_CONFIG: Dict[str, Any] = {
    "paths": {
        "prefix": "data/",
        "checkpoint_dir": "models/weights",
        "tb_log_file_dir": "tb_logs/",
    },
    "network": {
        "encoder": {
            "in_channels": 2,
            "num_layers": 2,
            "kernel_size": 3,
            "channel_size": 64,
        },
        "recursive": {
            "alpha_residual": True,
            "in_channels": 64,
            "num_layers": 2,
            "kernel_size": 3,
        },
        "decoder": {
            "deconv": {"in_channels": 64, "kernel_size": 3, "stride": 3, "out_channels": 64},
            "final": {"in_channels": 64, "kernel_size": 1, "out_channels": 1},
        },
    },
    "training": {
        "num_epochs": 400,
        "batch_size": 8,
        "min_L": 2,
        "n_views": 8,
        "n_workers": 4,
        "crop": 3,
        "lr": 0.0007,
        "lr_step": 2,
        "lr_decay": 0.97,
        "load_lr_maps": False,
        "beta": 50.0,
        "create_patches": True,
        "patch_size": 64,
        "val_proportion": 0.10,
        "lambda": 0.000001,
        # training criterion: 'cPSNR' (reference objective), 'cMSE', or
        # 'masked_MSE' (reference switch: src/train.py:66-87)
        "loss": "cPSNR",
        # TPU-native additions (absent keys default sensibly):
        "seed": 123,
        "compute_dtype": "float32",  # or "bfloat16"
        "data_parallel": True,
        "eval_batch_size": 1,
        # full-resumable-state save period in epochs; 1 = every epoch,
        # 0 = best-weights only during the run + one final state save
        "checkpoint_every": 1,
        # global-norm gradient clip; 0 disables (reference-exact bare Adam,
        # src/train.py:252). An unlucky init can diverge from epoch 1 at
        # the paper-scale protocol (observed: seed 1, loss -> ~1e23-output
        # territory while healthy seeds reach 16 dB); set ~1.0 to rescue.
        "grad_clip_norm": 0.0,
        # parameter EMA decay; > 0 tracks an exponential moving average of
        # both models' params inside the train step; best-model selection
        # then scores BOTH raw and EMA weights each epoch and ships the
        # winner (train/state.py, train/selection.py). 0 = off
        # (reference-exact) — and the measured recommendation: dual
        # selection makes the knob at-worst-neutral, but it has never been
        # observed to WIN (plateau-decay paper scale: harmful under the old
        # EMA-only selection, neutral under dual; constant-LR arms at 0.99
        # and 0.999 both shipped raw weights with identical best scores —
        # RECIPE_EMA_{BASE,99,999}.json). Keep it off unless your protocol
        # shows otherwise via the returned ema_selection evidence.
        "ema_decay": 0.0,
        # per-scene random D4 rotation/flip each epoch (data/augment.py);
        # the reference never augments. false = off (reference-exact).
        "augment_dihedral": False,
        # variable-L training: with this probability a scene's view stack is
        # truncated to a random k in [1, L-1] before collation (alpha marks
        # the padding, exactly the reference's any-L padding contract,
        # src/utils.py:89-95) so ONE checkpoint serves 1..L views instead of
        # specializing to exactly n_views (the VIEWS_ABLATION clip-floor
        # artifact). 0 = off (reference-exact fixed-L batches).
        "variable_views_p": 0.0,
        # validation view-count mixture: [k1, k2, ...] scores the val set
        # at several view counts (full stack always included; entries <
        # min_L add truncated lists) and selects/schedules on the MEAN —
        # the selection criterion for variable-L training. [] = off
        # (reference-exact single full-L val).
        "val_views": [],
        # out-of-range output penalty: > 0 adds rp * mean(relu(sr-1) +
        # relu(-sr)) on the raw SR output — drives the clip-floor artifact
        # (outputs leaving [0,1] at untrained view counts) to zero at the
        # loss level. 0 = off (reference-exact loss).
        "range_penalty": 0.0,
        # single-view inference policy: a fusion model fed ONE view measures
        # below plain bicubic (paper Fig. 1; −0.88 dB measured,
        # VIEWS_ABLATION_VARL_FT_RP.json), so "warn" (default) flags such
        # scenes, "bicubic" routes them to the stronger 3x bicubic baseline,
        # "model" keeps the reference-exact silent behavior.
        "single_view_policy": "warn",
        # fine-tune: load params + BN stats from another run's best/ snapshot
        # (value = that run's run_dir) into a FRESH run — new optimizer, new
        # schedule, new run_dir. Distinct from resume (which restores the
        # full train state in the same run_dir). "" = off.
        "init_params_from": "",
        # loss-time warp window extension: K > 0 decomposes predicted shifts
        # into an exact integer slice (±K px) + 7-tap fractional pass
        # (ops/lanczos.py int_range) so the registered loss stays accurate
        # beyond the reference's ~±3 px. 0 = reference-exact single pass.
        "warp_int_range": 0,
        # stop when this many epochs pass with no val improvement; the best
        # weights are served either way. 0 = run all epochs (reference-exact).
        "early_stop_patience": 0,
        # pre-collate the (fixed) val set once and replay it every epoch:
        # decode-free and deterministic (seeded view sampling). false
        # restores the reference's stochastic per-epoch val loader
        # (src/train.py:284).
        "cache_val_batches": True,
        # supervised ShiftNet pretraining on known Lanczos shifts before
        # joint training; needed for the registered loss to bootstrap at
        # multi-pixel misalignment (REGISTER_ABLATION.json). 0 = off.
        "shiftnet_warmup_steps": 0,
        "shiftnet_warmup_sigma": 1.5,
        # train WITHOUT loss-time registration for the first N epochs so
        # HRNet forms a stable output frame first. 0 = off.
        "register_warmup_epochs": 0,
        # device mesh layout, e.g. {"data": 4, "view": 2}; null = 1-D data
        # parallelism over all local devices when data_parallel is true.
        "mesh": None,
        # > 0: serve training batches from N pre-collated memory-mapped
        # epoch realizations instead of per-epoch PNG/pack decodes.
        "epoch_cache_variants": 0,
    },
}


# Registration-toolkit config (the reference's root config.json schema:
# image/mask paths, accumulated deltas, arrow-key step sizes).
DEFAULT_REGISTRATION_CONFIG: Dict[str, Any] = {
    "reference_image": "",
    "reference_mask": "",
    "template_image": "",
    "template_mask": "",
    "current_deltax": 0.0,
    "current_deltay": 0.0,
    "shift_step_x": 0.05,
    "shift_step_y": 0.05,
}


def load_registration_config(path: str = "config.json") -> Dict[str, Any]:
    """Load the registration toolkit config merged over its defaults.

    Missing file -> defaults; unknown keys warn and are ignored
    (reference: registration_helpers.py:21-43).
    """
    cfg = dict(DEFAULT_REGISTRATION_CONFIG)
    if not os.path.exists(path):
        warnings.warn(f"registration config {path!r} not found; using defaults")
        return cfg
    with open(path) as f:
        try:
            user = json.load(f)
        except json.JSONDecodeError as e:
            warnings.warn(f"invalid registration config JSON ({e}); using defaults")
            return cfg
    unknown = set(user) - set(DEFAULT_REGISTRATION_CONFIG)
    if unknown:
        warnings.warn(f"Unknown registration config fields ignored: {unknown}")
    cfg.update({k: v for k, v in user.items() if k in DEFAULT_REGISTRATION_CONFIG})
    return cfg


def _merge(base: Dict[str, Any], override: Dict[str, Any], path: str = "") -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in override.items():
        where = f"{path}.{k}" if path else k
        if k not in out:
            out[k] = copy.deepcopy(v)
        elif isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v, where)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str | None = None, overrides: Dict[str, Any] | None = None) -> Dict[str, Any]:
    """Load a JSON config merged over DEFAULT_CONFIG.

    Unknown top-level sections warn (mirroring the registration toolkit's
    defaults-merge with unknown-key warnings, registration_helpers.py:21-43).
    """
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    if path is not None:
        with open(path) as f:
            user = json.load(f)
        for k in user:
            # "_"-prefixed keys are documentation (JSON has no comments)
            if k not in DEFAULT_CONFIG and not k.startswith("_"):
                warnings.warn(f"Unknown config section: {k!r}")
        cfg = _merge(cfg, user)
    if overrides:
        cfg = _merge(cfg, overrides)
    return cfg
