"""Tensor helpers shared by the terrain and coregistration modules."""

from xdem_tpu_torch.ops.interp import grid_coords, interp_points, interp_rowcol
from xdem_tpu_torch.ops.reductions import masked_median, masked_nmad, nanmean, nanmedian, nanstd, nmad
from xdem_tpu_torch.ops.transfer import device_mask, unmask

__all__ = ["grid_coords", "interp_points", "interp_rowcol", "masked_median", "masked_nmad", "nanmean", "nanmedian",
           "nanstd", "nmad", "device_mask", "unmask"]
