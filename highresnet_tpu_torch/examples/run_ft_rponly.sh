#!/bin/bash
# Regenerate the fixed-L base checkpoint, then run the rp-only fixed-L
# fine-tune arm through the port: the fourth cell of the restart x
# range-penalty 2x2 (ft_ctl, varL_ft and varL_ft_rp are the other three).
# The port's counterpart of scripts/run_ft_rponly.sh, without the TPU
# supervisor: a leg that stops is relaunched by running this script again,
# and resumes from its run dir (stable names, --checkpoint-every 10).
#
# The base is the same-seed 100-epoch fixL run; selection keeps its best
# epoch. A complete base is best/ plus its best_score.json sidecar; a run
# killed mid-regen leaves best/ from an early epoch. Determinism
# cross-check: the first base this script sees has its best_score.json
# recorded beside the run dirs; every later (regenerated or kept) base must
# read the same epoch and score, or the script stops before fine-tuning.
#
# Data and run dirs go under $TMPDIR/hrn_varl_data (build/hrn_varl_data
# in the checkout when TMPDIR is unset), reports under build/examples/; the
# arguments pass through to every leg, e.g.
#
#   bash highresnet_tpu_torch/examples/run_ft_rponly.sh [--device cpu]
set -u
cd "$(dirname "$0")/../.." || exit 1

ROOT="${TMPDIR:-$PWD/build}/hrn_varl_data"
CKPT="$ROOT/ckpt"
REPORTS=build/examples
COMMON=(--root "$ROOT" --scenes-per-channel 580 --views 16
        --lr-size 48 --detail 0.5 --hr-shift 0.0 --batch 32 --patch 32
        --lr-decay 0.97 --seed 0 --val-proportion 0.1 --epochs 100
        --checkpoint-every 10)
BASE="$CKPT/fixL"
mkdir -p "$REPORTS"

if [ ! -d "$BASE/best" ] || [ ! -f "$BASE/best_score.json" ]; then
  python -m highresnet_tpu_torch.examples.quality_experiment "${COMMON[@]}" \
    --lr 7e-4 --run-name fixL --out "$REPORTS/RECIPE_FIXL_REGEN.json" "$@" || exit 1
fi

python - "$BASE/best_score.json" "$CKPT/fixL_first_best_score.json" <<'PY' || exit 1
import json, os, shutil, sys
got_path, first_path = sys.argv[1:3]
got = json.load(open(got_path))
if not os.path.isfile(first_path):
    shutil.copyfile(got_path, first_path)
    print(f"fixL base recorded as the first: epoch={got.get('epoch')} score={got['score']:.4f}")
    sys.exit(0)
first = json.load(open(first_path))
if got.get("epoch") != first.get("epoch") or abs(got["score"] - first["score"]) >= 5e-4:
    sys.exit(f"fixL base mismatch: best_score.json={got}, the first base read {first}. "
             f"Stale or partial base: delete {os.path.dirname(got_path)} and rerun.")
print(f"fixL base verified: epoch={got.get('epoch')} score={got['score']:.4f}")
PY

python -m highresnet_tpu_torch.examples.quality_experiment "${COMMON[@]}" \
  --lr 2e-4 --init-from "$BASE" \
  --range-penalty 10 --variable-views-p 0.0 \
  --run-name ft_rponly --out "$REPORTS/RECIPE_FT_RPONLY.json" "$@"
