"""The DEM elevation object: Raster subclass with vertical CRS and terrain/coreg/uncertainty API.

Port of xdem_tpu/dem.py. The terrain wrappers call `terrain.get_terrain_attribute`, so a DEM
on a CUDA device runs the hand-written kernels (K1, K2, K3) and returns Rasters on that
device. `to_vcrs` transforms the elevations on their device in float64, in row bands.
`to_pointcloud` gives an elevation point cloud (EPC) on the DEM's device.
"""

from __future__ import annotations

import warnings
from typing import Any, Literal, Sequence

import torch

from xdem_tpu_torch import terrain as _terrain
from xdem_tpu_torch._misc import copy_doc
from xdem_tpu_torch.raster import Raster, band_coords, row_bands
from xdem_tpu_torch.vcrs import _parse_vcrs_from_product, _transform_zz, _vcrs_from_user_input

# Product tags with a known vertical reference (upstream xdem's vcrs.py)
_VCRS_FROM_PRODUCT = {
    "ArcticDEM": "Ellipsoid",
    "REMA": "Ellipsoid",
    "EarthDEM": "Ellipsoid",
    "TDM1": "Ellipsoid",
    "NASADEM-HGTS": "Ellipsoid",
    "AW3D30": "EGM96",
    "SRTMv4.1": "EGM96",
    "SRTMGL1": "EGM96",
    "ASTGTM2": "EGM96",
    "NASADEM-HGT": "EGM96",
    "COPDEM": "EGM08",
}


class DEM(Raster):
    """A single-band digital elevation model with vertical CRS handling."""

    def __init__(self, *args: Any, vcrs: Any = None, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self._vcrs = None
        # Parse vcrs priority: user input > VCRS file tag > product tag (the VCRS tag is the
        # file persistence of set_vcrs)
        if vcrs is None:
            vcrs = self.tags.get("VCRS")
        if vcrs is None:
            product = self.tags.get("PRODUCT")
            if product is not None:
                vcrs = _parse_vcrs_from_product(product)
        if vcrs is not None:
            self.set_vcrs(vcrs)

    @classmethod
    def from_array(
        cls,
        data: Any,
        transform: Any,
        crs: Any,
        nodata: float | None = None,
        area_or_point: str = "Area",
        tags: dict[str, str] | None = None,
        cast_nodata: bool = True,
        vcrs: Any = None,
    ) -> "DEM":
        """Build a DEM from an array + georeferencing, optionally with a vertical CRS."""
        out = super().from_array(data, transform, crs, nodata=nodata,
                                 area_or_point=area_or_point, tags=tags, cast_nodata=cast_nodata)
        if vcrs is not None:
            out.set_vcrs(vcrs)
        return out

    # ------------------------------------------------------------------ vertical CRS

    @property
    def vcrs(self) -> Any:
        return self._vcrs

    @property
    def vcrs_name(self) -> str | None:
        return None if self._vcrs is None else str(self._vcrs)

    def set_vcrs(self, new_vcrs: Any) -> None:
        """Set the vertical CRS ('Ellipsoid', 'EGM96', 'EGM08', EPSG code, or grid name)."""
        self._vcrs = _vcrs_from_user_input(new_vcrs)

    def to_vcrs(self, vcrs: Any, force_source_vcrs: Any = None, *,
                inplace: bool = False) -> "DEM | None":
        """Transform elevations to another vertical CRS, on the DEM's device in float64.

        With the built-in EGM96/EGM2008 field (no registered PROJ grid), expect ~2.5 m
        median / ~9 m p90 error on typical land (5-fold held-out cross-validation over the
        ~130 fitted station undulations), ~1-3 m at the stations themselves, and up to
        ~15-25 m in remote ocean areas; register a precise undulation grid
        (vcrs.register_geoid_grid) for survey-grade (cm-dm) work.
        ``inplace=True`` mutates this DEM and returns None.
        """
        src = self._vcrs if force_source_vcrs is None else _vcrs_from_user_input(force_source_vcrs)
        if src is None:
            raise ValueError(
                "The DEM has no vertical CRS defined; set one with set_vcrs() or pass force_source_vcrs."
            )
        dst = _vcrs_from_user_input(vcrs)
        if src == dst:
            warnings.warn(
                "Source and destination vertical CRS are the same, skipping vertical transformation.",
                category=UserWarning,
            )
            return None
        h, w = self.shape
        zz = torch.empty((h, w), dtype=self.data.dtype, device=self.data.device)
        for r0, r1 in row_bands(self.shape):
            x, y = band_coords(self.transform, r0, r1, w, self.data.device)
            zz[r0:r1] = _transform_zz(src, dst, self.crs, x, y, self.data[r0:r1].to(torch.float64))
        if inplace:
            self.data = zz
            self._vcrs = dst
            return None
        out = self.copy(new_array=zz)
        out._vcrs = dst
        return out

    @property
    def vcrs_grid(self) -> str | None:
        """Grid name of the vertical CRS."""
        from xdem_tpu_torch.vcrs import grid_name_for

        return grid_name_for(self._vcrs)

    @property
    def ccrs(self):
        """Compound (horizontal + vertical) CRS description string."""
        if self._vcrs is None:
            return None
        return f"{self.crs!r} + {self._vcrs}"

    def save(self, path: str, **kwargs) -> None:
        """Write the DEM as GeoTIFF, persisting the vertical CRS in the file metadata."""
        if self._vcrs is not None:
            self.tags["VCRS"] = str(self._vcrs)
        super().save(path, **kwargs)

    def info(self, stats: bool = False, verbose: bool = True) -> str:
        """Summary of the DEM's georeferencing (as upstream xdem's, the default prints; pass
        ``verbose=False`` for quiet use).

        :param stats: Also include value statistics (min/max/mean/median/std/NMAD).
        :param verbose: Also print the summary (returns it either way).
        """
        import numpy as np

        arr = self._host()
        lines = [
            f"Driver:             GeoTIFF (native codec)",
            f"Size:               {self.width}, {self.height}",
            f"Coordinate system:  {self.crs!r}",
            f"Vertical CRS:       {self.vcrs_name or 'None'}",
            f"Resolution:         {self.res}",
            f"Bounds:             {tuple(self.bounds)}",
            f"Nodata:             {self.nodata}",
            f"Valid pixels:       {int(np.isfinite(arr).sum())} / {arr.size}",
        ]
        if stats:
            s = self.get_stats()
            lines += [
                f"[MINIMUM]:          {s['min']:.2f}",
                f"[MAXIMUM]:          {s['max']:.2f}",
                f"[MEAN]:             {s['mean']:.2f}",
                f"[MEDIAN]:           {s['median']:.2f}",
                f"[STD DEV]:          {s['std']:.2f}",
                f"[NMAD]:             {s['nmad']:.2f}",
            ]
        text = "\n".join(lines)
        if verbose:
            print(text)
        return text

    # ------------------------------------------------------------------ terrain attributes

    @copy_doc(_terrain, "slope")
    def slope(
        self,
        method: Literal["Horn", "ZevenbergThorne"] | None = None,
        surface_fit: Literal["Horn", "ZevenbergThorne", "Florinsky"] = "Florinsky",
        degrees: bool = True,
        **kwargs: Any,
    ) -> Raster:
        return _terrain.slope(self, method=method, surface_fit=surface_fit, degrees=degrees, **kwargs)

    @copy_doc(_terrain, "aspect")
    def aspect(
        self,
        method: Literal["Horn", "ZevenbergThorne"] | None = None,
        surface_fit: Literal["Horn", "ZevenbergThorne", "Florinsky"] = "Florinsky",
        degrees: bool = True,
        **kwargs: Any,
    ) -> Raster:
        return _terrain.aspect(self, method=method, surface_fit=surface_fit, degrees=degrees, **kwargs)

    @copy_doc(_terrain, "hillshade")
    def hillshade(
        self,
        method: Literal["Horn", "ZevenbergThorne"] | None = None,
        surface_fit: Literal["Horn", "ZevenbergThorne", "Florinsky"] = "Florinsky",
        azimuth: float = 315.0,
        altitude: float = 45.0,
        z_factor: float = 1.0,
        **kwargs: Any,
    ) -> Raster:
        return _terrain.hillshade(self, method=method, surface_fit=surface_fit, azimuth=azimuth,
                                  altitude=altitude, z_factor=z_factor, **kwargs)

    @copy_doc(_terrain, "curvature")
    def curvature(
        self,
        surface_fit: Literal["ZevenbergThorne", "Florinsky"] = "Florinsky",
        **kwargs: Any,
    ) -> Raster:
        return _terrain.curvature(self, surface_fit=surface_fit, **kwargs)

    @copy_doc(_terrain, "profile_curvature")
    def profile_curvature(
        self,
        surface_fit: Literal["ZevenbergThorne", "Florinsky"] = "Florinsky",
        curv_method: Literal["geometric", "directional"] = "geometric",
        **kwargs: Any,
    ) -> Raster:
        return _terrain.profile_curvature(self, surface_fit=surface_fit, curv_method=curv_method, **kwargs)

    @copy_doc(_terrain, "tangential_curvature")
    def tangential_curvature(
        self,
        surface_fit: Literal["ZevenbergThorne", "Florinsky"] = "Florinsky",
        curv_method: Literal["geometric", "directional"] = "geometric",
        **kwargs: Any,
    ) -> Raster:
        return _terrain.tangential_curvature(self, surface_fit=surface_fit, curv_method=curv_method, **kwargs)

    @copy_doc(_terrain, "planform_curvature")
    def planform_curvature(
        self,
        surface_fit: Literal["ZevenbergThorne", "Florinsky"] = "Florinsky",
        curv_method: Literal["geometric", "directional"] = "geometric",
        **kwargs: Any,
    ) -> Raster:
        return _terrain.planform_curvature(self, surface_fit=surface_fit, curv_method=curv_method, **kwargs)

    @copy_doc(_terrain, "flowline_curvature")
    def flowline_curvature(
        self,
        surface_fit: Literal["ZevenbergThorne", "Florinsky"] = "Florinsky",
        curv_method: Literal["geometric", "directional"] = "geometric",
        **kwargs: Any,
    ) -> Raster:
        return _terrain.flowline_curvature(self, surface_fit=surface_fit, curv_method=curv_method, **kwargs)

    @copy_doc(_terrain, "max_curvature")
    def max_curvature(
        self,
        surface_fit: Literal["ZevenbergThorne", "Florinsky"] = "Florinsky",
        curv_method: Literal["geometric", "directional"] = "geometric",
        **kwargs: Any,
    ) -> Raster:
        return _terrain.max_curvature(self, surface_fit=surface_fit, curv_method=curv_method, **kwargs)

    @copy_doc(_terrain, "min_curvature")
    def min_curvature(
        self,
        surface_fit: Literal["ZevenbergThorne", "Florinsky"] = "Florinsky",
        curv_method: Literal["geometric", "directional"] = "geometric",
        **kwargs: Any,
    ) -> Raster:
        return _terrain.min_curvature(self, surface_fit=surface_fit, curv_method=curv_method, **kwargs)

    @copy_doc(_terrain, "topographic_position_index")
    def topographic_position_index(self, window_size: int = 3, **kwargs: Any) -> Raster:
        return _terrain.topographic_position_index(self, window_size=window_size, **kwargs)

    @copy_doc(_terrain, "terrain_ruggedness_index")
    def terrain_ruggedness_index(
        self,
        method: Literal["Riley", "Wilson"] = "Riley",
        window_size: int = 3,
        **kwargs: Any,
    ) -> Raster:
        return _terrain.terrain_ruggedness_index(self, method=method, window_size=window_size, **kwargs)

    @copy_doc(_terrain, "roughness")
    def roughness(self, window_size: int = 3, **kwargs: Any) -> Raster:
        return _terrain.roughness(self, window_size=window_size, **kwargs)

    @copy_doc(_terrain, "rugosity")
    def rugosity(self, **kwargs: Any) -> Raster:
        return _terrain.rugosity(self, **kwargs)

    @copy_doc(_terrain, "fractal_roughness")
    def fractal_roughness(self, window_size_fractal: int = 13, **kwargs: Any) -> Raster:
        return _terrain.fractal_roughness(self, window_size_fractal=window_size_fractal, **kwargs)

    @copy_doc(_terrain, "texture_shading")
    def texture_shading(self, alpha: float = 0.8, **kwargs: Any) -> Raster:
        return _terrain.texture_shading(self, alpha=alpha, **kwargs)

    def get_terrain_attribute(self, attribute: str | Sequence[str], **kwargs: Any) -> Any:
        return _terrain.get_terrain_attribute(self, attribute, **kwargs)

    # ------------------------------------------------------------------ coreg / uncertainty

    def coregister_3d(
        self,
        reference_elev: Any,
        coreg_method: Any = None,
        inlier_mask: Any = None,
        bias_vars: dict[str, Any] | None = None,
        random_state: int | None = None,
        **kwargs: Any,
    ) -> "DEM":
        """Coregister THIS DEM to a reference elevation dataset (``self`` is the to-be-aligned
        data; the argument is the reference); returns the aligned DEM."""
        if coreg_method is None:
            from xdem_tpu_torch.coreg import NuthKaab

            coreg_method = NuthKaab()
        if random_state is not None:
            kwargs.setdefault("random_state", random_state)
        return coreg_method.fit_and_apply(reference_elev, self.copy(), inlier_mask=inlier_mask,
                                          bias_vars=bias_vars, **kwargs)

    def estimate_uncertainty(
        self,
        other_elev: Any,
        stable_terrain: Any = None,
        approach: Literal["H2022", "R2009", "Basic"] = "H2022",
        precision_of_other: Literal["finer", "same"] = "finer",
        spread_estimator: Any = None,
        variogram_estimator: str = "dowd",
        list_vars: tuple = ("slope", "max_curvature"),
        list_vario_models: tuple = ("gaussian", "spherical"),
        z_name: str = "z",
        random_state: int | None = None,
        subsample: int = 1000,
        mesh: Any = None,
    ) -> tuple:
        """Estimate uncertainty of the elevation difference to another elevation dataset.

        Returns (error raster sigma(x, y), correlation function rho(lag)). H2022 =
        heteroscedasticity + multi-range variogram; R2009 = constant error + multi-range;
        Basic = NMAD + single-range. ``other_elev`` is a DEM/Raster (reprojected onto this
        DEM's grid when they differ) or an elevation point cloud (EPC/PointCloud, or a data
        frame with x/y columns and ``z_name``). ``spread_estimator``
        defaults to the NMAD and ``variogram_estimator`` to Dowd. ``mesh`` (a `parallel.Mesh`)
        shards the raster pipeline (see `uncertainty.estimate_uncertainty`).
        """
        from xdem_tpu_torch import uncertainty as _unc

        return _unc.estimate_uncertainty(
            self,
            other_elev,
            stable_terrain=stable_terrain,
            approach=approach,
            precision_of_other=precision_of_other,
            spread_estimator=spread_estimator,
            variogram_estimator=variogram_estimator,
            list_vars=list_vars,
            list_vario_models=list_vario_models,
            z_name=z_name,
            random_state=random_state,
            subsample=subsample,
            mesh=mesh,
        )

    def to_pointcloud(self, data_column_name: str = "z", subsample: int | float = 1,
                      random_state: int | None = None, **kwargs: Any):
        """Valid pixels as an elevation point cloud (EPC) carrying the DEM's vertical CRS, on
        the DEM's device; see Raster.to_pointcloud for the skip_nodata/as_array/
        force_pixel_offset options."""
        from xdem_tpu_torch.epc import EPC

        pc = super().to_pointcloud(data_column_name=data_column_name, subsample=subsample,
                                   random_state=random_state, **kwargs)
        if kwargs.get("as_array"):
            return pc
        epc = EPC(x=pc.x, y=pc.y, z=pc.z, crs=pc.crs, data_column=pc.data_column)
        epc._vcrs = self._vcrs
        return epc
