"""Wrappers of the hand-written CUDA terrain kernels K1, K2 and K3, and of the DEM's centre.

Each wrapper takes a float32 tensor (K1-K3 an (H, W) one). On a CUDA tensor it launches its
kernel (``csrc/surface_fit.cu``, ``csrc/windowed.cu``, ``csrc/fractal.cu``, ``csrc/center.cu``)
or raises; on a CPU tensor, and only then, it runs the plain PyTorch version of the same
function. There is no fallback from the card to the plain version.

``LAUNCHES`` counts the launches of K1-K3 per wrapper, ``CALL_LAUNCHES`` those of the centre:
each wrapper adds one where it launches its kernel and nowhere else, so a run can show that it
went through the kernels. They are apart because a mesh runs K1-K3 once a shard and the centre
once a call (on the whole DEM's card); ``reset_launch_counts`` zeroes both.
"""

from __future__ import annotations

import numpy as np
import torch

from xdem_tpu_torch import _build
from xdem_tpu_torch.profiler import span
from xdem_tpu_torch.terrain import surfit, window

LAUNCHES = {"surface_fit": 0, "windowed": 0, "fractal": 0}
CALL_LAUNCHES = {"center": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, CALL_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _on_card(dem: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version); True for a CUDA tensor the kernels accept.
    Raises for any other device and for inputs the kernels do not take."""
    if dem.device.type == "cpu":
        return False
    if dem.device.type != "cuda":
        raise ValueError(f"The terrain kernels run on CUDA or CPU tensors, not on {dem.device}.")
    if dem.dtype != torch.float32 or dem.dim() != 2 or not dem.is_contiguous():
        raise ValueError(
            f"The terrain kernels take a contiguous 2-D float32 tensor, got dtype={dem.dtype}, "
            f"shape={tuple(dem.shape)}, contiguous={dem.is_contiguous()}."
        )
    if dem.shape[0] >= 2**31 or dem.shape[1] >= 2**31:
        raise ValueError(f"Raster shape {tuple(dem.shape)} exceeds the kernels' int32 extents.")
    return True


def _launch(name: str, fn, dem: torch.Tensor, out: torch.Tensor, *args) -> torch.Tensor:
    """Launch a kernel on the current stream of the input's device; raise if refused."""
    with torch.cuda.device(dem.device):
        stream = torch.cuda.current_stream(dem.device).cuda_stream
        rc = fn(dem.data_ptr(), out.data_ptr(), dem.shape[0], dem.shape[1], *args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}.")
    LAUNCHES[name] += 1
    return out


def _codes(attrs: tuple[str, ...], table: tuple[str, ...]) -> np.ndarray:
    for a in attrs:
        if a not in table:
            raise ValueError(f"Unknown attribute {a!r}: choose from {table}.")
    return np.array([table.index(a) for a in attrs], dtype=np.int32)


def _plan(attrs: tuple[str, ...], table: tuple[str, ...]) -> tuple[int, np.ndarray]:
    """(mask, plane_of) of a request against a kernel's attribute table: bit ``a`` of ``mask`` is
    set where the attribute with code ``a`` (its place in ``table``) is requested, and
    ``plane_of[a]`` is the index in ``attrs`` of the plane it is written to (its first mention;
    -1 where it is not requested)."""
    plane_of = np.full(len(table), -1, dtype=np.int32)
    for i, code in enumerate(_codes(tuple(attrs), table)):
        if plane_of[code] < 0:
            plane_of[code] = i
    mask = sum(1 << a for a in np.flatnonzero(plane_of >= 0))
    return int(mask), plane_of


def surface_fit_plan(attrs: tuple[str, ...]) -> tuple[int, np.ndarray]:
    """(mask, plane_of) of a request as K1 takes them, codes from ``surfit.SURFACE_FIT_ATTRS``."""
    return _plan(attrs, surfit.SURFACE_FIT_ATTRS)


def windowed_plan(attrs: tuple[str, ...]) -> tuple[int, np.ndarray]:
    """(mask, plane_of) of a request as K2 takes them, codes from ``window.WINDOWED_ATTRS``."""
    return _plan(attrs, window.WINDOWED_ATTRS)


def _copy_repeats(out: torch.Tensor, attrs: tuple[str, ...]) -> torch.Tensor:
    """An attribute named twice: the kernel wrote its first plane, the others are copies."""
    for i, a in enumerate(attrs):
        first = attrs.index(a)
        if first != i:
            out[i].copy_(out[first])
    return out


def surface_attributes(
    dem: torch.Tensor,
    resolution: float,
    attrs: tuple[str, ...],
    surface_fit: str = "Florinsky",
    curv_method: str = "geometric",
    hillshade_altitude: float = 45.0,
    hillshade_azimuth: float = 315.0,
    hillshade_z_factor: float = 1.0,
    center: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """K1: surface-fit attributes as a (len(attrs), H, W) stack; see surfit.surface_attributes.

    `center` (a tensor, a float or None) replaces the DEM's own mean as the constant removed
    before the stencils, as in the plain version. On a CUDA tensor the centre reaches the
    kernel as a device pointer to a 0-dim float32 tensor (``dem_center(dem)`` when `center`
    is None), and nothing here reads a device value on the host: no ``float()``,
    ``.item()`` or ``.cpu()``, so the call returns without waiting for the card.
    """
    if not _on_card(dem):
        return surfit.surface_attributes(dem, resolution, attrs, surface_fit, curv_method,
                                         hillshade_altitude, hillshade_azimuth, hillshade_z_factor, center)
    attrs = tuple(attrs)
    mask, plane_of = surface_fit_plan(attrs)
    roles, names, _ = surfit.fit_plan(attrs, surface_fit)
    out = torch.empty((len(attrs), *dem.shape), dtype=torch.float32, device=dem.device)
    if dem.numel() == 0:
        return out
    divisors = np.array([float(d) for d in surfit.divisors(roles, names, resolution)], dtype=np.float32)
    sin_alt, cos_alt, azimuth = surfit.hillshade_constants(hillshade_altitude, hillshade_azimuth)
    if center is None:
        center = dem_center(dem)
    if isinstance(center, torch.Tensor):
        center = center.to(device=dem.device, dtype=torch.float32).reshape(()).contiguous()
    else:  # filled on the card: a host scalar copied over would make the stream wait
        center = torch.full((), float(center), dtype=torch.float32, device=dem.device)
    _launch(
        "surface_fit", _build.load().launch_surface_fit, dem, out,
        list(surfit._FIT_DERIVS).index(surface_fit.lower()), int(curv_method.lower() == "geometric"),
        len(roles), divisors.ctypes.data, mask, plane_of.ctypes.data, center.data_ptr(),
        sin_alt, cos_alt, azimuth, float(hillshade_z_factor),
    )
    return _copy_repeats(out, attrs)


def windowed_indexes(
    dem: torch.Tensor,
    resolution: float,
    attrs: tuple[str, ...],
    window_size: int = 3,
    tri_method: str = "Riley",
) -> torch.Tensor:
    """K2: windowed indexes as a (len(attrs), H, W) stack; see window.windowed_indexes.

    The kernel takes any window_size >= 1, by one of three routes, all bit-equal to the plain
    version (NaN masks included): the 3 x 3 window (the default, and the only one with
    rugosity) as compile-time instances that compute the half-lengths of the Jenness geometry
    once per tile in shared memory; any other window up to the last one whose tile fits in
    shared memory (``_build.load().windowed_max_shared_window()``), four pixels per thread; larger
    windows by bounds-checked global reads, one pixel per thread. The request reaches the kernel
    as a bit mask and a plane per attribute (``windowed_plan``), in any order; an attribute named
    twice is computed once and copied. The rugosity geometry and the attribute codes reach the
    kernel through ``windowed_tables.h``, which ``_build.windowed_header()`` writes from
    ``window.py``. The source note of ``csrc/windowed.cu`` gives the design.
    """
    if not _on_card(dem):
        return window.windowed_indexes(dem, resolution, attrs, window_size, tri_method)
    w = int(window_size)
    if w < 1:
        raise ValueError(f"window_size must be positive, got {window_size}.")
    if "rugosity" in attrs and w != 3:
        raise ValueError("Rugosity is only defined on a 3x3 window.")
    attrs = tuple(attrs)
    mask, plane_of = windowed_plan(attrs)
    out = torch.empty((len(attrs), *dem.shape), dtype=torch.float32, device=dem.device)
    if dem.numel() == 0:
        return out
    _launch(
        "windowed", _build.load().launch_windowed, dem, out,
        w, int(tri_method.lower() == "riley"), mask, plane_of.ctypes.data, float(resolution),
    )
    return _copy_repeats(out, attrs)


def fractal_roughness(dem: torch.Tensor, window_size: int = 13) -> torch.Tensor:
    """K3: fractal roughness as an (H, W) tensor; see window.fractal_roughness.

    The kernel takes any window_size >= 5, by one of three routes, all bit-equal to the
    plain version: the odd windows 5-21 (13 is the default) as compile-time instances on
    64 x 32 tiles, 4 pixels per thread; any other window up to the last one whose planes fit
    in shared memory (``_build.load().fractal_max_shared_window()``) with the same
    box-maxima planes at runtime scales, one pixel per thread; larger windows by
    bounds-checked global reads. The source note of ``csrc/fractal.cu`` gives the design.

    Smaller windows raise ValueError on the card, as the reference's Pallas kernel does,
    while a CPU tensor goes to the plain version, which takes window_size >= 3 as the
    reference's XLA path does: so windows 3 and 4 succeed or raise by device.
    """
    if not _on_card(dem):
        return window.fractal_roughness(dem, window_size)
    w = int(window_size)
    if w < 5:
        raise ValueError("Fractal roughness requires window size >= 5.")
    qs, log_q, mx, ss_xx = window.fractal_scales(w)
    q_arr = np.array(qs, dtype=np.int32)
    lq_arr = np.array(log_q, dtype=np.float32)
    out = torch.empty(dem.shape, dtype=torch.float32, device=dem.device)
    if dem.numel() == 0:
        return out
    return _launch(
        "fractal", _build.load().launch_fractal, dem, out,
        w, len(qs), q_arr.ctypes.data, lq_arr.ctypes.data, mx, ss_xx,
    )


def dem_center(dem: torch.Tensor) -> torch.Tensor:
    """The DEM's centre (see surfit.dem_center) as a 0-dim tensor on its device: the mean of its
    finite values, 0 where none is finite.

    On a CUDA float32 tensor of any shape, one read of it (``csrc/center.cu``: per-block
    partials in a fixed order, then one block adds them): the mean accumulated in float64 and
    rounded once, the same bits on every call. A tensor that is not contiguous is copied
    first. Nothing is read back: the call returns without waiting for the card. It runs in the
    plain version's span, ``terrain.center``, whose ``kernel`` counter counts the launch.
    """
    if dem.device.type == "cpu":
        return surfit.dem_center(dem)
    if dem.device.type != "cuda":
        raise ValueError(f"The terrain kernels run on CUDA or CPU tensors, not on {dem.device}.")
    if dem.dtype != torch.float32:
        raise ValueError(f"The centre kernel takes a float32 tensor, got {dem.dtype}.")
    with span("xdem_tpu_torch.terrain.center", devices=[dem.device]) as s:
        dem = dem.contiguous()
        lib = _build.load()
        n = dem.numel()
        scratch = torch.empty(2 * lib.center_blocks(n), dtype=torch.float64, device=dem.device)
        out = torch.empty((), dtype=torch.float32, device=dem.device)
        with torch.cuda.device(dem.device):
            stream = torch.cuda.current_stream(dem.device).cuda_stream
            rc = lib.launch_center(dem.data_ptr(), n, scratch.data_ptr(), out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel center failed to launch: cudaError {rc}.")
        CALL_LAUNCHES["center"] += 1
        s.count("kernel")
    return out
