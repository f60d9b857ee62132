#!/bin/bash
# Drive the shipped flagship configs end-to-end through the port's CLI
# surface (cli.train + cli.predict --tta 8), the port's counterpart of
# scripts/run_flagship_config.sh without the TPU supervisor:
#
#   control          configs/flagship.json minus the recipe knobs
#                    (reference-default training on identical data)
#   flagship         configs/flagship.json        (+ predict --tta 8)
#   flagship_ft_rp   configs/flagship_ft_rp.json  (stage-2 fine-tune)
#   flagship_ft_varl configs/flagship_ft_varl.json (stage-3, the
#                    measured-best composition cell)
#
# then writes build/examples/FLAGSHIP_CONFIG_DRIVE.json. The arc is
# flagship_config_report.drive; the control and ft_varl predict legs run
# with RuntimeWarning as an error. Data and run dirs go under
# $TMPDIR/hrn_flagship_cfg; the arguments pass through, e.g.
#
#   bash highresnet_tpu_torch/examples/run_flagship_config.sh [--device cpu] [--root DIR]
cd "$(dirname "$0")/../.." || exit 1
exec python -m highresnet_tpu_torch.examples.flagship_config_report --drive "$@"
