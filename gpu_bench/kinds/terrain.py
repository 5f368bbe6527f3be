"""Kind "terrain": ``terrain.get_terrain_attribute(dem, attributes, resolution=, window_size=3,
window_size_fractal=)`` on the configuration's DEMs, with ``mesh=`` over the cell's cards when
the configuration lays the tile out on a mesh. The windowed indexes run on 3 x 3 (rugosity's
window, and the one gpu_bench/work.py counts).
"""

from __future__ import annotations

import numpy as np
import torch

from gpu_bench import compare, inputs


class Work:
    """The terrain suite on a pool of DEMs, on one device or over a mesh of devices."""

    def __init__(self, config: dict, mix: dict, seed: int, devices: list[torch.device], size: int | None = None):
        self.config, self.mix, self.devices = config, mix, devices
        self.n = int(size or config["size_px"])
        self.res = float(config["pixel_m"])
        self.attrs = list(mix["attributes"])
        self.wsf = int(mix.get("window_size_fractal", 13))
        layout = config.get("mesh")
        self.mesh = None
        if layout:
            from xdem_tpu_torch.parallel import make_mesh

            self.mesh = make_mesh(devices=devices[:layout[0] * layout[1]], shape=tuple(layout))
        self.pixels_per_call = self.n * self.n
        terrain_cfg, voids = config["assumed"]["terrain"], config["assumed"]["voids"]
        self.pool = []
        for i in range(int(mix["pool"])):
            z = inputs.spectral_dem(self.n, inputs.seed_ints(seed, 1, i), devices[0], terrain_cfg["exponent"],
                                    terrain_cfg["top_m"])[0]
            inputs.cut_voids(z, inputs.seed_ints(seed, 2, i), voids["count"], voids["min_px"],
                             min(voids["max_px"], self.n // 4), tuple(layout) if voids.get("seams") and layout else None)
            self.pool.append(z)
        self.rng = np.random.default_rng(inputs.seed_ints(seed, 3))

    def call(self, i: int, spans: dict) -> list:
        from xdem_tpu_torch import terrain

        return terrain.get_terrain_attribute(self.pool[i % len(self.pool)], self.attrs, resolution=self.res,
                                             window_size=3, window_size_fractal=self.wsf, mesh=self.mesh)

    def launches_per_call(self) -> int:
        """Launches of each kernel a call makes: one a shard on the card, none on the CPU."""
        if self.devices[0].type != "cuda":
            return 0
        return 1 if self.mesh is None else int(self.mesh.devices.size)

    def keep_inputs(self, indices) -> None:
        """Free every pool DEM but those the kept calls read."""
        keep = {i % len(self.pool) for i in indices}
        self.pool = [z if j in keep else None for j, z in enumerate(self.pool)]

    def check(self, kept: list[tuple[int, list]], ref_dtype=torch.float64) -> dict[str, float]:
        """{attribute: gap} over the kept calls (the largest of their gaps): every pixel of a
        one-device call; on a mesh, a seeded band of rows across each block, and apart from
        them, as {attribute.seams: gap}, a crop around the middle of every seam segment and
        every inner corner, so that a fault at the seams is not diluted by the blocks."""
        worst: dict[str, float] = {}
        for i, planes in kept:
            dem = self.pool[i % len(self.pool)]
            if self.mesh is None:
                groups = {"": compare.band_regions(dem.shape, int(self.mix["check"]["band_rows"]))}

                def got(r0, r1, c0, c1, planes=planes):
                    return [p[r0:r1, c0:c1] for p in planes]
            else:
                groups = self._mesh_regions(dem.shape)

                def got(r0, r1, c0, c1, planes=planes, dev=dem.device):
                    return [p.window(slice(r0, r1), slice(c0, c1), dev) for p in planes]
            for suffix, regions in groups.items():
                shares = compare.terrain_gaps(dem, got, regions, self.res, self.attrs, self.wsf, ref_dtype)
                for a, s in shares.items():
                    worst[a + suffix] = max(worst.get(a + suffix, 0.0), s)
        return worst

    def _mesh_regions(self, shape) -> dict[str, list[tuple[int, int, int, int]]]:
        chk = self.mix["check"]
        my, mx = self.mesh.devices.shape
        bh, bw = -(-shape[0] // my), -(-shape[1] // mx)
        bands = []
        for iy in range(my):
            for ix in range(mx):
                height = min(bh, shape[0] - iy * bh)
                rows = min(int(chk["band_rows"]), height)
                r0 = iy * bh + int(self.rng.integers(0, height - rows + 1))
                bands.append((r0, r0 + rows, ix * bw, min((ix + 1) * bw, shape[1])))
        side = min(int(chk["seam_crop"]), bh, bw)
        return {"": bands, ".seams": compare.crop_regions(inputs.seam_points(shape, (my, mx)), side, shape)}


class _ControlPlanes:
    """The control's planes of one call: the plain reference in `dtype`, computed for each
    window the check reads (the last window's planes are kept for the other attributes)."""

    def __init__(self, work: Work, dem, dtype):
        self.work, self.dem, self.dtype, self.last = work, dem, dtype, (None, None)

    def block(self, rows: slice, cols: slice) -> dict:
        key = (rows.start, rows.stop, cols.start, cols.stop)
        if self.last[0] != key:
            from gpu_bench import reference

            w = self.work
            planes = reference.terrain_block(self.dem, key[:2], key[2:], w.res, w.attrs, self.dtype, w.wsf)
            self.last = (key, {a: p.float() for a, p in planes.items()})
        return self.last[1]


class _ControlPlane:
    def __init__(self, planes: _ControlPlanes, attr: str):
        self.planes, self.attr = planes, attr

    def __getitem__(self, index):
        rows, cols = index
        return self.planes.block(rows, cols)[self.attr]

    def window(self, rows: slice, cols: slice, device=None):
        return self[rows, cols]


def control(work: Work, dtype):
    """The call with the plain reference in `dtype` in the program's place."""

    def call(i, spans):
        planes = _ControlPlanes(work, work.pool[i % len(work.pool)], dtype)
        return [_ControlPlane(planes, a) for a in work.attrs]

    return call
