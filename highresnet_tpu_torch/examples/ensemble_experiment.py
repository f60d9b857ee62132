"""HighRes-net+ ensemble with MEMBER PARITY (paper Table 1 protocol).

The paper's leaderboard-best entry averages the SR outputs of two
same-protocol models. This runs the protocol with two (or more) seeds
trained IDENTICALLY (same dataset, epochs, views, lr), each keeping its
best-validation weights, then scores each member, the naive SR-average
ensemble, and the REGISTERED ensemble on the same held-out scenes.

Registered ensemble: the shift-invariant cPSNR objective never pins a
model's absolute output frame, so independent seeds converge to frames
offset from each other and raw averaging blurs. Each member is PCC-aligned
to the anchor member's frame (registration/search.py::pcc_align_batch, K3
on the card) before averaging. Least-squares stacking weights are fit on
half the scenes and scored on the other half, and a deployment rule picks
the candidate on the fit half.

    python -m highresnet_tpu_torch.examples.ensemble_experiment [--epochs 250] [--seeds 0,1] \
        [--out build/examples/ENSEMBLE_REPORT.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

EDGE_CROP = 8  # px of the warp's edge band left out of the stacking fit


def _align(ref, mov):
    """``mov`` (H, W) PCC-aligned onto ``ref``'s frame, and its (dy, dx)."""
    from highresnet_tpu_torch.registration.search import pcc_align_batch

    aligned, d = pcc_align_batch(ref[None], mov[None])
    return aligned[0], d[0]


def ensemble_rows(fwds, tta_fwds, best_val, val_dirs, views: int, device):
    """Per scene: each member's score (``seed<s>``), with TTA each member's
    registered TTA (``tta<s>``) and the full stack, every pair's naive
    (``ens<a><b>``) and registered (``rens<a><b>``) average, with more than
    two members the all-member naive and registered averages. Returns
    (rows, offsets per pair, per-scene anchor-frame member stacks)."""
    import numpy as np
    import torch

    from highresnet_tpu_torch.data import collate
    from highresnet_tpu_torch.exp import harness

    seeds = list(fwds)
    pair_keys = list(itertools.combinations(seeds, 2))
    anchor = sorted(seeds, key=lambda s_: best_val[s_])[0]
    rows, scene_data = [], []
    offsets = {k: [] for k in pair_keys}
    for d in val_dirs:
        s = harness.read_scene(d, views)
        batch = collate([s], views)
        srs = {seed: fwds[seed](batch.lrs, batch.alphas)[0] for seed in seeds}
        score = harness.scene_scorer(s, device)
        row = {"scene": s.name}
        for seed in seeds:
            row[f"seed{seed}"] = score(srs[seed])
        if tta_fwds:
            # full stack: registered dihedral TTA per member, then the
            # members' TTA outputs PCC-registered to the anchor member's
            # TTA frame and averaged (ensemble-of-self-ensembles)
            ttas = {seed: tta_fwds[seed](batch.lrs, batch.alphas)[0] for seed in seeds}
            for seed in seeds:
                row[f"tta{seed}"] = score(ttas[seed])
            t_anchor = ttas[anchor]
            t_stack = torch.stack([t_anchor] + [_align(t_anchor, ttas[s_])[0]
                                                for s_ in seeds if s_ != anchor])
            row["full_stack"] = score(t_stack.mean(0))
        for a, b in pair_keys:
            # anchor on the pair's better-val member (the one users would
            # ship standalone), align the other onto its output frame
            a0, b0 = sorted((a, b), key=lambda s_: best_val[s_])
            row[f"ens{a}{b}"] = score((srs[a] + srs[b]) / 2.0)
            aligned, dyx = _align(srs[a0], srs[b0])
            offsets[(a, b)].append([float(v) for v in dyx.cpu()])
            row[f"rens{a}{b}"] = score((srs[a0] + aligned) / 2.0)
        # every member in the anchor's output frame (anchor stays pristine)
        stack = torch.stack([srs[anchor]] + [_align(srs[anchor], srs[s_])[0]
                                             for s_ in seeds if s_ != anchor])
        if len(seeds) > 2:
            row["ens_all"] = score(torch.stack(list(srs.values())).mean(0))
            row["rens_all"] = score(stack.mean(0))
        scene_data.append((stack.cpu().numpy(), np.asarray(s.hr), np.asarray(s.hr_map)))
        rows.append(row)
        if len(rows) % 10 == 0:
            print(f"[eval] {len(rows)}/{len(val_dirs)} scenes", flush=True)
    return rows, offsets, scene_data


def stack_weights(scene_data, device):
    """Ridgeless least-squares combination weights over the anchor-frame
    member stacks: the HR PCC-aligned into the anchor frame, per-image means
    removed (cPSNR's bias term), the warp's edge band cropped."""
    import numpy as np
    import torch

    k, c = scene_data[0][0].shape[0], EDGE_CROP
    G, rhs = np.zeros((k, k)), np.zeros(k)
    for stack, hr, hrm in scene_data:
        ref = torch.as_tensor(stack[0], device=device)
        hr_a = _align(ref, torch.as_tensor(hr, dtype=torch.float32, device=device))[0].cpu().numpy()
        X = stack[:, c:-c, c:-c].reshape(k, -1)
        m = hrm[c:-c, c:-c].reshape(-1) > 0
        X = X[:, m] - X[:, m].mean(axis=1, keepdims=True)
        y = hr_a[c:-c, c:-c].reshape(-1)[m]
        y = y - y.mean()
        G += X @ X.T
        rhs += X @ y
    return np.linalg.solve(G, rhs)


def stacked_scores(w, scene_data, device):
    """Shift-cPSNR of each scene's weighted member stack."""
    import torch

    from highresnet_tpu_torch.ops.metrics import shift_cpsnr

    wt = torch.as_tensor(w, dtype=torch.float32, device=device)
    out = []
    for stack, hr, hrm in scene_data:
        img = torch.einsum("k,khw->hw", wt, torch.as_tensor(stack, device=device))
        out.append(float(shift_cpsnr(img.clamp(0.0, 1.0),
                                     torch.as_tensor(hr, dtype=torch.float32, device=device),
                                     torch.as_tensor(hrm, dtype=torch.float32, device=device))))
    return out


def main(argv=None):
    from highresnet_tpu_torch.exp.harness import default_out, default_root

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=default_root("hrn_ensemble_data"))
    ap.add_argument("--scenes-per-channel", type=int, default=300)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--lr-size", type=int, default=48)
    ap.add_argument("--detail", type=float, default=0.5)
    ap.add_argument("--epochs", type=int, default=250)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--patch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=7e-4)
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--val-proportion", type=float, default=0.1)
    ap.add_argument(
        "--early-stop-patience", type=int, default=0,
        help="training.early_stop_patience passthrough (0 = run all epochs); "
        "member parity needs matched stopping, so the same patience applies "
        "to every seed",
    )
    ap.add_argument("--max-scenes", type=int, default=40)
    ap.add_argument("--regen", action="store_true")
    ap.add_argument(
        "--fresh-test-seed", type=int, default=None,
        help="evaluate on a FRESH synthetic dataset generated with this "
        "seed (same protocol, never seen by any member or by training-time "
        "validation) instead of the shared val split",
    )
    ap.add_argument("--fresh-test-scenes", type=int, default=100,
                    help="scenes per channel for the fresh test set")
    ap.add_argument(
        "--tta", type=int, default=0, choices=[0, 4, 8],
        help="also score each member under registered dihedral TTA and the "
        "FULL STACK (registered ensemble of the members' TTA outputs)",
    )
    ap.add_argument("--out", default=default_out("ENSEMBLE_REPORT.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from highresnet_tpu_torch.config import load_config
    from highresnet_tpu_torch.data import discover_scenes, train_val_split
    from highresnet_tpu_torch.eval.evaluator import Forward
    from highresnet_tpu_torch.exp import harness
    from highresnet_tpu_torch.runtime import setup_device
    from highresnet_tpu_torch.train.loop import train_and_get_best_model

    device = setup_device(args.device)
    harness.ensure_dataset(
        args.root,
        scenes_per_channel=args.scenes_per_channel,
        views=args.views,
        lr_size=args.lr_size,
        seed=0,
        detail=args.detail,
        regen=args.regen,
    )

    seeds = [int(s) for s in args.seeds.split(",")]
    members = {}
    for seed in seeds:
        config = load_config(
            overrides={
                "paths": {
                    "prefix": args.root,
                    "checkpoint_dir": os.path.join(args.root, f"ckpt_seed{seed}"),
                    "tb_log_file_dir": "",
                },
                "training": {
                    "num_epochs": args.epochs,
                    "batch_size": args.batch,
                    "n_views": args.views,
                    "min_L": args.views,
                    "patch_size": args.patch,
                    "register_size": 2 * args.patch,
                    "val_proportion": args.val_proportion,
                    "eval_batch_size": 4,
                    "checkpoint_every": 25,  # resumable
                    "lr": args.lr,
                    "early_stop_patience": args.early_stop_patience,
                    "seed": seed,  # the ONLY difference between members
                    "data_parallel": False,
                },
            }
        )
        print(f"[seed {seed}] restoring or training...", flush=True)
        t0 = time.time()
        out = train_and_get_best_model(
            config, run_dir=os.path.join(args.root, f"ckpt_seed{seed}", "run"), device=device
        )
        members[seed] = {
            "model": harness.model_from_params(config, out["params"]["hrnet"], device),
            "best_val": float(out["best_score"]),
            "train_seconds": round(time.time() - t0, 1),
        }
        print(f"[seed {seed}] best_val={out['best_score']:.3f} "
              f"({members[seed]['train_seconds']:.0f}s)", flush=True)

    fwds = {s: Forward.plain(members[s]["model"], device, host=False) for s in seeds}
    tta_fwds = ({s: Forward.tta(members[s]["model"], device, transforms=args.tta, register=True,
                                host=False) for s in seeds} if args.tta else {})

    if args.fresh_test_seed is not None:
        fresh_root = os.path.join(args.root, f"fresh_test_{args.fresh_test_seed}")
        harness.ensure_dataset(
            fresh_root,
            scenes_per_channel=args.fresh_test_scenes,
            views=args.views,
            lr_size=args.lr_size,
            seed=args.fresh_test_seed,
            detail=args.detail,
            pack=False,
        )
        val = discover_scenes(os.path.join(fresh_root, "train"))[: args.max_scenes]
    else:
        scenes = discover_scenes(os.path.join(args.root, "train"))
        _, val = train_val_split(scenes, args.val_proportion, seed=1)
        val = val[: args.max_scenes]

    # the paper ensembles TWO models; with >2 trained seeds the pair is
    # chosen by VALIDATION score (lower = better -shift_cPSNR): a
    # pre-registered selection rule, no test peeking
    best_val = {s: members[s]["best_val"] for s in seeds}
    pair_keys = list(itertools.combinations(seeds, 2))
    val_pair = tuple(sorted(seeds, key=best_val.get)[:2])
    anchor = sorted(seeds, key=best_val.get)[0]
    rows, offsets, scene_data = ensemble_rows(fwds, tta_fwds, best_val, val, args.views, device)

    # ---- stacked (least-squares weighted) registered ensemble -----------
    # weights fit on the even-index scenes, scored on the odd-index ones
    member_order = [anchor] + [s_ for s_ in seeds if s_ != anchor]
    w = stack_weights(scene_data[0::2], device)
    stack_w = {f"seed{s_}": round(float(wi), 4) for s_, wi in zip(member_order, w)}

    def half_means(idxs):
        out = {f"seed{s_}": float(np.mean([rows[i][f"seed{s_}"] for i in idxs]))
               for s_ in seeds}
        if len(seeds) > 2:
            out["rens_all"] = float(np.mean([rows[i]["rens_all"] for i in idxs]))
        if args.tta:
            for s_ in seeds:
                out[f"tta{s_}"] = float(np.mean([rows[i][f"tta{s_}"] for i in idxs]))
            out["full_stack"] = float(np.mean([rows[i]["full_stack"] for i in idxs]))
        out["stacked"] = float(np.mean(stacked_scores(w, [scene_data[i] for i in idxs], device)))
        return out

    fit_idx = list(range(0, len(rows), 2))
    test_idx = list(range(1, len(rows), 2))
    fit, test = half_means(fit_idx), half_means(test_idx)
    best_test_single = max((v for k_, v in test.items() if k_.startswith("seed")))
    # deployment rule: pick the best candidate on the FIT half, ship it,
    # report its score on the unseen test half
    selected = max(fit, key=fit.get)
    stacking = {
        "protocol": "weights fit on even-index scenes (ridgeless LS, anchor-frame stacks, HR PCC-aligned, mean-centered, 8px edge crop); scored on odd-index scenes the weights never saw",
        "weights": stack_w,
        "n_fit_scenes": len(fit_idx),
        "n_test_scenes": len(test_idx),
        "fit_half_mean_shift_cpsnr": {k_: round(v, 4) for k_, v in fit.items()},
        "test_half_mean_shift_cpsnr": {k_: round(v, 4) for k_, v in test.items()},
        "stacked_minus_best_single_db": round(test["stacked"] - best_test_single, 3),
        "selected_on_fit_half": selected,
        "selected_test_score": round(test[selected], 4),
        "selected_minus_best_single_db": round(test[selected] - best_test_single, 3),
    }

    means = {k: float(np.mean([r[k] for r in rows])) for k in rows[0] if k != "scene"}
    # headline = REGISTERED all-member ensemble (every trained member, no
    # subset selection); the val-selected pair is reported too
    ens_key = "rens_all" if len(seeds) > 2 else f"rens{val_pair[0]}{val_pair[1]}"
    means["ensemble"] = means[ens_key]
    best_single_key = max((k for k in means if k.startswith("seed")), key=means.get)
    wins = sum(
        r[ens_key] > max(r[k] for k in means if k.startswith("seed")) for r in rows
    )
    off_stats = {
        f"{a}-{b}": {
            "mean_dyx": [round(float(v), 3) for v in np.mean(offsets[(a, b)], axis=0)],
            "std_dyx": [round(float(v), 3) for v in np.std(offsets[(a, b)], axis=0)],
        }
        for a, b in pair_keys
    }
    report = {
        "what": (
            "HighRes-net+ SR-average ensemble with member parity "
            "(identical-protocol seeds, best-val member selection); "
            "rens* = members PCC-registered to a common output frame "
            "before averaging, ens* = naive raw average"
        ),
        "inter_member_output_offsets_px": off_stats,
        "stacking": stacking,
        "ensemble_members_selected_by_val": list(val_pair),
        "protocol": {
            "eval_set": (
                f"fresh synthetic dataset, generator seed {args.fresh_test_seed} "
                "(never seen by any member or by training-time validation)"
                if args.fresh_test_seed is not None
                else "shared val split (train_val_split seed=1)"
            ),
            "n_eval_scenes": len(val),
            "scenes": 2 * args.scenes_per_channel,
            "views": args.views,
            "lr_size": args.lr_size,
            "detail": args.detail,
            "epochs": args.epochs,
            "batch": args.batch,
            "lr": args.lr,
            "seeds": seeds,
            "early_stop_patience": args.early_stop_patience,
            "device": harness.device_label(device),
        },
        "member_best_val": {str(s): members[s]["best_val"] for s in seeds},
        "member_train_seconds": {str(s): members[s]["train_seconds"] for s in seeds},
        "val_mean_shift_cpsnr": means,
        "best_single": best_single_key,
        "ensemble_minus_best_single_db": round(means["ensemble"] - means[best_single_key], 3),
        "scenes_where_ensemble_beats_both": f"{wins}/{len(rows)}",
        "per_scene": rows,
    }
    if args.tta:
        best_tta_single = max((k for k in means if k.startswith("tta")), key=means.get)
        report["tta_transforms"] = args.tta
        report["full_stack_minus_best_single_db"] = round(
            means["full_stack"] - means[best_single_key], 3)
        report["full_stack_minus_best_tta_single_db"] = round(
            means["full_stack"] - means[best_tta_single], 3)
    harness.emit_report(args.out, report, slim_drop=("per_scene",))
    return report


if __name__ == "__main__":
    main()
