from highresnet_tpu_torch.models.convert import (
    hrnet_state_dict_from_flax,
    load_weights,
    shiftnet_state_dict_from_flax,
    vgg_state_dict_from_flax,
)
from highresnet_tpu_torch.models.hrnet import HRNet, lower_median, param_count
from highresnet_tpu_torch.models.shiftnet import ShiftNet, apply_shifts, register_views

__all__ = [
    "HRNet",
    "ShiftNet",
    "apply_shifts",
    "hrnet_state_dict_from_flax",
    "load_weights",
    "lower_median",
    "param_count",
    "register_views",
    "shiftnet_state_dict_from_flax",
    "vgg_state_dict_from_flax",
]
