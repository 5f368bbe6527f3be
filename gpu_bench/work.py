"""The frozen work count of a terrain request: bytes and f32 operations per pixel.

It counts what a request needs, from the request alone (attributes, windows, shape), and
never reads the program: whatever implements the suite, the count stays the same. Bytes are
the DEM read once and each output plane written once. Operations are f32 operations with a
fused multiply-add counted as two, against the peaks below.

Per pixel:
  * K1 (surface fit, Florinsky 5 x 5): a multiply and an add per non-zero stencil tap of each
    derivative the request needs, two per derivative (centring, divisor) and 20 per attribute
    formula;
  * K2 (windowed indexes, w = 3): TPI 13, TRI 28, roughness 19 and rugosity 193 (16
    half-lengths of 6, 8 Heron triangles of 12, one division);
  * K3 (fractal roughness, window w): see ``fractal_ops_per_pixel``;
  * the epilog: one operation per plane converted to degrees, two for hillshade's clamp.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet, 700 W): HBM3 bandwidth, and the f32 rate outside
# the tensor cores, which counts a fused multiply-add as two operations.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Non-zero taps of Florinsky's (2009) 5 x 5 stencils, eqs. 12-20: z_x and z_y 20 each, z_xx and
# z_yy 25 each, z_xy 16.
FLORINSKY_TAPS = {"z_x": 20, "z_y": 20, "z_xx": 25, "z_yy": 25, "z_xy": 16}

SURFACE_FIT = ("slope", "aspect", "hillshade", "curvature", "profile_curvature", "tangential_curvature",
               "planform_curvature", "flowline_curvature", "max_curvature", "min_curvature")
CURVATURES = SURFACE_FIT[3:]
WINDOWED_OPS = {"topographic_position_index": 13, "terrain_ruggedness_index": 28, "roughness": 19, "rugosity": 193}
EPILOG_OPS = {"slope": 1, "aspect": 1, "hillshade": 2}


def fractal_ops_per_pixel(w: int) -> int:
    """f32 operations of fractal roughness per pixel at window w (Taud & Parrot 2005, box
    counting over the divisors q of w // 2): a subtraction, a max, a min and an add per box, a
    row and a column max per plane value for each factor of a box-maxima plane's build, the
    five operations of log(Ns / q) into the two sums per scale, and the slope's six."""
    hw = w // 2
    ops = 6
    for q in (d for d in range(1, hw + 1) if hw % d == 0):
        nq = (w - 1) // q
        ops += 4 * nq * nq + 5
        if q > 1:
            src = max(d for d in range(1, q) if q % d == 0)
            ops += 2 * (q // src - 1)
    return ops


def kernel_work(attrs, window_size_fractal: int = 13) -> dict[str, tuple[int, int]]:
    """{kernel: (bytes, operations) per pixel} of the families a request touches: "k1" the
    surface-fit attributes, "k2" the windowed indexes at w = 3, "k3" fractal roughness."""
    sf = [a for a in attrs if a in SURFACE_FIT]
    win = [a for a in attrs if a in WINDOWED_OPS]
    out = {}
    if sf:
        roles = ["z_x", "z_y"] + (["z_xx", "z_yy", "z_xy"] if any(a in CURVATURES for a in sf) else [])
        taps = sum(FLORINSKY_TAPS[r] for r in roles)
        out["k1"] = (4 * (1 + len(sf)), 2 * taps + 2 * len(roles) + 20 * len(sf))
    if win:
        out["k2"] = (4 * (1 + len(win)), sum(WINDOWED_OPS[a] for a in win))
    if "fractal_roughness" in attrs:
        out["k3"] = (8, fractal_ops_per_pixel(window_size_fractal))
    return out


def suite_work(attrs, window_size_fractal: int = 13) -> tuple[int, int]:
    """(bytes, operations) per pixel of the whole request: the DEM read once, every plane
    written once, and the operations of every family plus the epilog."""
    ops = sum(o for _, o in kernel_work(attrs, window_size_fractal).values())
    ops += sum(EPILOG_OPS.get(a, 0) for a in attrs)
    return 4 * (1 + len(attrs)), ops


def least_seconds(nbytes: float, ops: float, chips: int = 1) -> float:
    """The least time `chips` cards could take: the larger of bytes over their bandwidth and
    operations over their f32 rate."""
    return max(nbytes / (chips * HBM_BYTES_PER_S), ops / (chips * F32_OPS_PER_S))
