#!/bin/bash
# The round-5 measurement queue through the port (run after
# run_ft_rponly.sh), the counterpart of scripts/run_round5_queue.sh without
# the TPU supervisor:
#   1. the views-ablation curve of the rp-only fixed-L fine-tune;
#   2. a deterministic rerun of the restart-only control, recording the
#      full per-epoch val trajectory;
#   3. the composition cell: a variable-L fine-tune from the rp-only
#      checkpoint;
#   4. the views-ablation curve of that cell;
#   5. the range-penalty sweep rp in {30, 100} at fixed L, each with its
#      ablation curve.
# Every training leg resumes from its run dir when the script is run again
# (stable names, --checkpoint-every 10). Data and run dirs go under
# $TMPDIR/hrn_varl_data (build/hrn_varl_data in the checkout when TMPDIR is
# unset), reports under build/examples/; the arguments pass through to every
# leg, e.g.
#
#   bash highresnet_tpu_torch/examples/run_round5_queue.sh [--device cpu]
set -u
cd "$(dirname "$0")/../.." || exit 1

ROOT="${TMPDIR:-$PWD/build}/hrn_varl_data"
CKPT="$ROOT/ckpt"
REPORTS=build/examples
COMMON=(--root "$ROOT" --scenes-per-channel 580 --views 16
        --lr-size 48 --detail 0.5 --hr-shift 0.0 --batch 32 --patch 32
        --lr-decay 0.97 --seed 0 --val-proportion 0.1 --epochs 100
        --checkpoint-every 10)
mkdir -p "$REPORTS"

run_ablation () { # run_dir out, then the pass-through arguments
  local run="$1" out="$2"
  shift 2
  python -m highresnet_tpu_torch.examples.views_ablation --root "$ROOT" \
    --checkpoint "$run" --max-scenes 30 --out "$out" "$@"
}

fine_tune () { # init_from run_name out, then the driver's flags
  local init="$1" name="$2" out="$3"
  shift 3
  python -m highresnet_tpu_torch.examples.quality_experiment "${COMMON[@]}" \
    --lr 2e-4 --init-from "$init" --run-name "$name" --out "$out" "$@"
}

# 1. rp-only low-L curve
[ -f "$REPORTS/VIEWS_ABLATION_FT_RPONLY.json" ] || \
  run_ablation "$CKPT/ft_rponly" "$REPORTS/VIEWS_ABLATION_FT_RPONLY.json" "$@" || exit 1

# 2. restart-only control, same seed and protocol, with its val history
fine_tune "$CKPT/fixL" ft_ctl "$REPORTS/RECIPE_FT_CTL.json" "$@" || exit 1

# 3. composition cell: variable-L + rp fine-tune from the rp-only best
fine_tune "$CKPT/ft_rponly" varL_ft_from_rp "$REPORTS/RECIPE_VARL_FT_FROM_RP.json" \
  --range-penalty 10 --variable-views-p 0.5 "$@" || exit 1

# 4. its low-L curve
run_ablation "$CKPT/varL_ft_from_rp" "$REPORTS/VIEWS_ABLATION_VARL_FT_FROM_RP.json" "$@" || exit 1

# 5. range-penalty sweep (fixed-L rp-only arms at 30 and 100)
for RP in 30 100; do
  fine_tune "$CKPT/fixL" "ft_rp$RP" "$REPORTS/RECIPE_FT_RP$RP.json" \
    --range-penalty "$RP" --variable-views-p 0.0 "$@" || exit 1
  run_ablation "$CKPT/ft_rp$RP" "$REPORTS/VIEWS_ABLATION_FT_RP$RP.json" "$@" || exit 1
done

echo "=== round-5 queue complete ==="
