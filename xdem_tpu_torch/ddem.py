"""dDEM: a difference of DEMs carrying its time interval, with gap filling.

Port of xdem_tpu/ddem.py. The data stay a tensor on their device; the gap fillers of
``volume`` run on the host in float64, as in xdem_tpu, so ``filled_data`` is a numpy array.
"""

from __future__ import annotations

from typing import Any, Literal

import numpy as np
import torch

from xdem_tpu_torch import volume as _volume
from xdem_tpu_torch.raster import Raster, mask_on


class dDEM(Raster):
    """A difference-DEM between two acquisition times."""

    def __init__(self, raster: Raster | Any, start_time: Any = None, end_time: Any = None, error: Any = None,
                 **kwargs: Any):
        if isinstance(raster, Raster):
            super().__init__(raster.data, raster.transform, raster.crs, nodata=raster.nodata,
                             area_or_point=raster.area_or_point)
        else:
            super().__init__(raster, **kwargs)
        self.start_time = start_time
        self.end_time = end_time
        self.error = error
        self._filled_data: np.ndarray | None = None
        self._fill_method = ""

    @property
    def filled_data(self) -> np.ndarray | None:
        """The gap-filled host array once interpolate() ran; before that the data themselves
        when they have no NaN, else None."""
        if self._filled_data is not None:
            return self._filled_data
        if bool(torch.isnan(self.data).any()):
            return None
        return self.get_nanarray()

    @filled_data.setter
    def filled_data(self, array: np.ndarray | None) -> None:
        if array is None:
            self._filled_data = None
            return
        array = np.asarray(array)
        if self.data.numel() != array.size:
            raise ValueError(
                f"Array shape '{array.shape}' differs from the data shape '{tuple(self.data.shape)}'"
            )
        self._filled_data = array.reshape(self.shape)

    @property
    def fill_method(self) -> str:
        """The method that made `filled_data` ("" before interpolate())."""
        return self._fill_method

    @property
    def time(self) -> Any:
        """The time interval of the dDEM (end minus start), or None."""
        if self.start_time is None or self.end_time is None:
            return None
        return self.end_time - self.start_time

    @classmethod
    def from_array(cls, data: Any, transform: Any, crs: Any, start_time: Any = None,
                   end_time: Any = None, nodata: Any = None, error: Any = None) -> "dDEM":
        """A dDEM from an array or tensor and its georeferencing."""
        return cls(Raster.from_array(data=data, transform=transform, crs=crs, nodata=nodata),
                   start_time=start_time, end_time=end_time, error=error)

    def interpolate(
        self,
        method: Literal["idw", "local_hypsometric", "regional_hypsometric"] = "idw",
        reference_elevation: Any = None,
        mask: Any = None,
    ) -> np.ndarray | None:
        """Fill the NaN gaps; stores and returns `filled_data`.

        The hypsometric methods need `reference_elevation` (a Raster on another grid is
        reprojected onto this one; an array must share its shape) and `mask` (a Vector, an
        array or a tensor) whose features are the glaciers.
        """
        if method == "idw":
            self.filled_data = _volume.idw_interpolation(self.data)
        elif method in ("local_hypsometric", "regional_hypsometric"):
            if reference_elevation is None:
                raise ValueError(f"'reference_elevation' must be given for method '{method}'.")
            if isinstance(reference_elevation, Raster):
                from xdem_tpu_torch.demcollection import _same_grid

                if not _same_grid(reference_elevation, self):
                    reference_elevation = reference_elevation.reproject(self)
                reference_elevation = reference_elevation.data
            if tuple(np.shape(reference_elevation)) != self.shape:
                raise ValueError(
                    f"'reference_elevation' shape {tuple(np.shape(reference_elevation))} differs from the dDEM's "
                    f"{self.shape}; pass a Raster/DEM (auto-reprojected) or a same-grid array."
                )
            if mask is None:
                raise ValueError(f"'mask' must be given for method '{method}'.")
            mask_arr = mask_on(mask, self, self.shape, self.data.device).cpu().numpy()
            if method == "local_hypsometric":
                filled = _volume.local_hypsometric_interpolation(self.data, reference_elevation, mask_arr)
            else:
                from scipy import ndimage

                labels, _ = ndimage.label(mask_arr)
                filled = _volume.norm_regional_hypsometric_interpolation(self.data, reference_elevation, labels)
            arr = self.get_nanarray()
            self.filled_data = np.where(np.isfinite(arr), arr, filled.filled(np.nan))
        else:
            raise ValueError(f"Unknown interpolation method: {method}")
        self._fill_method = method
        return self.filled_data
