"""Deterministic synthetic example datasets.

Port of xdem_tpu/examples.py (the same seeded arrays, so both packages hold the same data).
Upstream xdem downloads the Longyearbyen 1990/2009 DEM pair, glacier outlines and an ICESat-2
point cloud from the pinned xdem-data repository; here the datasets are generated with no
network: spectral-synthesis fractal terrain with the same grid characteristics (UTM 33N, 20 m
resolution, ~1000 m relief), a "later" DEM derived from the reference DEM by a known shift +
elevation-dependent change + noise, and glacier-outline-like polygons. The point cloud, the
dDEM and the coregistered DEM wait for their slices of the port (EPC, dDEM) and raise by name.
Files are cached under ``$XDEM_TPU_TORCH_EXAMPLES_DIR`` (default
``~/.cache/xdem_tpu_torch_examples``).
"""

from __future__ import annotations

import functools

import numpy as np

from xdem_tpu_torch.georef import Affine
from xdem_tpu_torch.vector import Vector

_CRS = 32633  # UTM 33N, like the Longyearbyen data
_RES = 20.0
_ORIGIN = (502810.0, 8674030.0)  # upper-left (west, north)
_SHAPE = (985, 1332)

# True offsets used to derive the "to-be-aligned" 1990-like DEM from the 2009-like reference
# DEM (what NuthKaab should recover, with opposite sign).
TBA_SHIFT = (-9.2, 4.6, -2.35)  # (east, north, up) metres applied to the tba DEM grid


def synthetic_dem_array(
    shape: tuple[int, int] = _SHAPE,
    resolution: float = _RES,
    seed: int = 42,
    relief: float = 1000.0,
    beta: float = 2.7,
) -> np.ndarray:
    """Spectral-synthesis fractal terrain: power-law |f|^-beta noise, normalized to [0, relief].

    The field is generated in pixel space; ``resolution`` is part of the signature so
    callers derive the georeferencing from one place, but it does not change the array
    (keeping the documented TBA_SHIFT truths resolution-independent).
    """
    rng = np.random.default_rng(seed)
    h, w = shape
    # Generate on a padded power-of-two grid for clean spectra
    n = int(2 ** np.ceil(np.log2(max(h, w))))
    fy = np.fft.fftfreq(n)[:, None]
    fx = np.fft.rfftfreq(n)[None, :]
    f = np.hypot(fx, fy)
    f[0, 0] = 1.0
    amp = f ** (-beta)
    amp[0, 0] = 0.0
    phase = rng.uniform(0, 2 * np.pi, size=amp.shape)
    spec = amp * np.exp(1j * phase)
    field = np.fft.irfft2(spec, s=(n, n))[:h, :w]
    field = field - field.min()
    field = field / field.max() * relief
    return field.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _base_arrays() -> dict[str, np.ndarray]:
    ref = synthetic_dem_array()
    rng = np.random.default_rng(1990)
    h, w = ref.shape

    # Glacier-like mask: a few smooth blobs in low-curvature areas
    yy, xx = np.mgrid[0:h, 0:w]
    mask = np.zeros((h, w), dtype=bool)
    for (cy, cx, ry, rx, ang) in [
        (300, 420, 90, 60, 0.4),
        (620, 900, 130, 80, -0.8),
        (180, 1000, 70, 110, 1.1),
        (760, 300, 100, 70, 0.2),
    ]:
        ca, sa = np.cos(ang), np.sin(ang)
        u = (xx - cx) * ca - (yy - cy) * sa
        v = (xx - cx) * sa + (yy - cy) * ca
        mask |= (u / rx) ** 2 + (v / ry) ** 2 < 1.0

    # The "to-be-aligned" DEM: reference shifted by TBA_SHIFT, glacier thinning, small noise.
    dx, dy, dz = TBA_SHIFT
    transform = Affine.from_origin(_ORIGIN[0], _ORIGIN[1], _RES, _RES)
    # Sample ref at (x - dx, y - dy): equivalent to shifting the terrain by (+dx, +dy).
    cols = (np.arange(w) + 0.5) - dx / _RES
    rows = (np.arange(h) + 0.5) + dy / _RES  # north shift decreases row index
    from scipy.ndimage import map_coordinates

    cgrid, rgrid = np.meshgrid(cols - 0.5, rows - 0.5)
    tba = map_coordinates(ref.astype(np.float64), [rgrid, cgrid], order=1, mode="constant", cval=np.nan)
    tba = tba + dz
    tba = tba - mask * (15.0 + 10.0 * np.sin(xx / 120.0) * np.cos(yy / 90.0))  # glacier elevation change
    tba = tba + rng.normal(0, 0.4, size=tba.shape)  # instrument noise
    tba = tba.astype(np.float32)

    return {"ref": ref, "tba": tba, "mask": mask, "transform": tuple(transform)}


def _transform() -> Affine:
    return Affine.from_origin(_ORIGIN[0], _ORIGIN[1], _RES, _RES)


def get_ref_dem():
    """Reference (later-date) synthetic DEM as a DEM object."""
    from xdem_tpu_torch.dem import DEM

    base = _base_arrays()
    return DEM.from_array(base["ref"].copy(), transform=_transform(), crs=_CRS)


def get_tba_dem():
    """To-be-aligned (earlier-date) synthetic DEM, offset by TBA_SHIFT from the reference."""
    from xdem_tpu_torch.dem import DEM

    base = _base_arrays()
    return DEM.from_array(base["tba"].copy(), transform=_transform(), crs=_CRS)


def get_glacier_mask() -> np.ndarray:
    """Boolean unstable-terrain (glacier) mask on the example grid."""
    return _base_arrays()["mask"].copy()


def get_glacier_outlines() -> Vector:
    """Glacier-like outlines as a Vector (coarse polygonization of the mask)."""
    mask = _base_arrays()["mask"]
    transform = _transform()
    polys = []
    # Trace each blob's convex outline from mask points (coarse but sufficient for masking tests)
    from scipy import ndimage

    labels, n = ndimage.label(mask)
    for i in range(1, n + 1):
        rr, cc = np.nonzero(labels == i)
        x, y = transform.xy(rr, cc)
        pts = np.column_stack([x, y])
        hull = _convex_hull(pts)
        polys.append([hull])
    return Vector(polys, crs=_CRS)


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Monotone-chain convex hull (closed ring)."""
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: list[np.ndarray] = []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    upper: list[np.ndarray] = []
    for p in pts[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    ring = np.array(lower[:-1] + upper[:-1] + [lower[0]])
    return ring


def get_epc(n_points: int = 50_000, seed: int = 7):
    """Sparse elevation point cloud sampled from the reference DEM (ICESat-2-like): uniform
    positions, bilinear heights of the reference terrain and 0.1 m of noise, drawn with
    numpy from `seed`. The EPC lies on the default device."""
    from scipy.ndimage import map_coordinates

    from xdem_tpu_torch.epc import EPC

    ref = _base_arrays()["ref"]
    transform = _transform()
    rng = np.random.default_rng(seed)
    h, w = ref.shape
    rr = rng.uniform(0, h - 1, n_points)
    cc = rng.uniform(0, w - 1, n_points)
    z = map_coordinates(ref.astype(np.float64), [rr, cc], order=1)
    x, y = transform.xy(rr, cc)
    return EPC(x=x, y=y, z=z + rng.normal(0, 0.1, n_points), crs=_CRS)


# (r0, r1, c0, c1): a 256x256 region chosen for aspect diversity (the synthetic terrain is
# smooth, so small crops can be single hillsides — degenerate for NuthKaab, like flat real
# terrain would be). Plays the role of upstream xdem's cropped test data.
_TEST_ICROP = (256, 512, 256, 512)


def get_ref_dem_test():
    """Small cropped variant of the reference DEM for fast tests."""
    r0, r1, c0, c1 = _TEST_ICROP
    return get_ref_dem().icrop((r0, r1), (c0, c1))


def get_tba_dem_test():
    r0, r1, c0, c1 = _TEST_ICROP
    return get_tba_dem().icrop((r0, r1), (c0, c1))


# ---------------------------------------------------------------------- path-based API
# Upstream xdem exposes file paths (examples.get_path/get_path_test) downloading the pinned
# xdem-data tarball. Here the same names resolve to deterministically generated files cached
# on disk.

import os as _os

_CACHE_DIR = _os.environ.get(
    "XDEM_TPU_TORCH_EXAMPLES_DIR", _os.path.join(_os.path.expanduser("~"), ".cache", "xdem_tpu_torch_examples")
)

available = [
    "giza_dem",
    "longyearbyen_ref_dem",
    "longyearbyen_tba_dem",
    "longyearbyen_glacier_outlines",
    "longyearbyen_glacier_mask",
    "longyearbyen_epc",
    "longyearbyen_ddem",
    "longyearbyen_tba_dem_coreg",
]

# Names also offered as cropped "_test" variants via get_path_test
available_test = [n for n in available if n != "giza_dem"]


def _generate(name: str, test: bool = False, output_dir: str | None = None,
              overwrite: bool = False) -> str:
    cache_dir = _CACHE_DIR if output_dir is None else output_dir
    _os.makedirs(cache_dir, exist_ok=True)
    suffix = "_test" if test else ""
    if name in ("longyearbyen_ref_dem", "longyearbyen_tba_dem", "longyearbyen_ddem",
                "longyearbyen_tba_dem_coreg", "longyearbyen_glacier_mask", "giza_dem"):
        path = _os.path.join(cache_dir, f"{name}{suffix}.tif")
    elif name == "longyearbyen_glacier_outlines":
        path = _os.path.join(cache_dir, f"{name}{suffix}.geojson")
    elif name == "longyearbyen_epc":
        path = _os.path.join(cache_dir, f"{name}{suffix}.npz")
    else:
        raise ValueError(f"Example '{name}' not in available: {available}")
    if _os.path.exists(path) and not overwrite:
        return path

    if name == "longyearbyen_ref_dem":
        (get_ref_dem_test() if test else get_ref_dem()).save(path)
    elif name == "giza_dem":
        get_giza_dem().save(path)
    elif name == "longyearbyen_tba_dem":
        (get_tba_dem_test() if test else get_tba_dem()).save(path)
    elif name == "longyearbyen_glacier_mask":
        from xdem_tpu_torch.raster import Raster

        mask = get_glacier_mask()
        ref = get_ref_dem()
        r = Raster(mask.astype(np.float32), ref.transform, ref.crs)
        if test:
            r0, r1, c0, c1 = _TEST_ICROP
            r = r.icrop((r0, r1), (c0, c1))
        r.save(path)
    elif name == "longyearbyen_glacier_outlines":
        get_glacier_outlines().save(path)
    elif name == "longyearbyen_epc":
        from xdem_tpu_torch.epc import write_epc

        write_epc(path, get_epc())
    elif name == "longyearbyen_ddem":
        from xdem_tpu_torch.dem import DEM

        ref = get_ref_dem()
        tba_coreg = DEM(_generate("longyearbyen_tba_dem_coreg", test=False, output_dir=output_dir))
        ddem = ref.copy(new_array=ref.data - tba_coreg.data.to(ref.data.device))
        if test:
            r0, r1, c0, c1 = _TEST_ICROP
            ddem = ddem.icrop((r0, r1), (c0, c1))
        ddem.save(path)
    elif name == "longyearbyen_tba_dem_coreg":
        # Nuth & Kaab with xdem_tpu's settings; its subsample is torch's draw, not jax.random's,
        # so the file agrees with xdem_tpu's to the coregistration's tolerance, not its bits.
        from xdem_tpu_torch import coreg

        ref, tba = get_ref_dem(), get_tba_dem()
        nk = coreg.NuthKaab(offset_threshold=0.005)
        aligned = nk.fit_and_apply(ref, tba, inlier_mask=~get_glacier_mask(), random_state=42)
        if test:
            r0, r1, c0, c1 = _TEST_ICROP
            aligned = aligned.icrop((r0, r1), (c0, c1))
        aligned.save(path)
    return path


def get_all_data(output_dir: str | None = None) -> str:
    """Generate (and cache) every example dataset; return the directory holding them.

    Upstream xdem downloads the pinned data tarball; here the datasets are synthesized
    deterministically. With ``output_dir`` the cached files are copied there.
    """
    import shutil

    paths = [_generate(name) for name in available]
    if output_dir is not None:
        _os.makedirs(output_dir, exist_ok=True)
        for p in paths:
            shutil.copy2(p, output_dir)
        return output_dir
    return _CACHE_DIR


def get_path(name: str, output_dir: str | None = None, overwrite: bool = False) -> str:
    """File path of an example dataset, generated and cached on first use.

    ``output_dir`` redirects the cache directory and ``overwrite`` regenerates the file even
    if cached (upstream they control the download; here the deterministic generation)."""
    return _generate(name, test=False, output_dir=output_dir, overwrite=overwrite)


def get_path_test(name: str, output_dir: str | None = None) -> str:
    """File path of the small cropped test variant of an example dataset."""
    return _generate(name, test=True, output_dir=output_dir)


def get_giza_dem():
    """Giza-like synthetic DSM: desert plain with pyramid structures (UTM 36N, 0.5 m res)."""
    from xdem_tpu_torch.dem import DEM

    rng = np.random.default_rng(2560)
    h, w = 600, 800
    base = synthetic_dem_array(shape=(h, w), resolution=0.5, seed=2560, relief=8.0, beta=2.2) + 60.0
    yy, xx = np.mgrid[0:h, 0:w]
    for (cy, cx, half, height) in [(300, 250, 115, 70), (320, 520, 80, 45), (180, 650, 35, 20)]:
        d = np.maximum(np.abs(xx - cx), np.abs(yy - cy)).astype(np.float64)
        pyramid = np.clip(height * (1 - d / half), 0, None)
        base = base + pyramid
    transform = Affine.from_origin(318000.0, 3286000.0, 0.5, 0.5)
    return DEM.from_array(base.astype(np.float32), transform=transform, crs=32636)
