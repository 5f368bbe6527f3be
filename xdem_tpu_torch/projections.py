"""Generic projection engine: ellipsoids, datum shifts, projection kernels, CRS parsers.

A copy of xdem_tpu/projections.py for the PyTorch port (a CPU test holds its tables equal to
the original's). Upstream xdem delegates all CRS work to pyproj; this module is the
self-contained equivalent: a normalized projection-definition dict ("projdef") drives
ufunc-only forward/inverse kernels (numpy, or the float-or-tensor torch namespace `TORCH`
below, via the `xp` argument, so a reprojection runs on the tensors' device), and three
front-ends produce projdefs:

  - `epsg_def(code)`  — a transcribed EPSG parameter table + range families (UTM et al.)
  - `parse_projstring("+proj=lcc +lat_1=...")` — PROJ.4-style strings
  - `parse_wkt("PROJCS[...]" / "PROJCRS[...]")` — WKT1 and WKT2

Normalized projdef keys (after `normalize_def`):
  proj      one of longlat, tmerc, merc, webmerc, lcc, lcc1sp, aea, laea, stere, sterea,
            somerc, cea, eqc
  a, f      ellipsoid semi-major axis [m] and flattening (f=0 -> sphere)
  lat_0, lon_0, lat_1, lat_2, lat_ts, k_0, x_0, y_0   projection parameters
            (lon_0 Greenwich-referenced; x_0/y_0 in METERS)
  towgs84   None or a 7-tuple (dx,dy,dz [m], rx,ry,rz [arcsec], ds [ppm]) position-vector
            Helmert to WGS84 (3-parameter shifts are stored with zero rotations/scale)
  to_meter  unit factor of the projected axes (projected coords = meters / to_meter)

Datum model: every horizontal transform goes projected -> own-datum geographic -> (Helmert via
ECEF) -> WGS84 geographic -> reverse on the destination side. GRS80-based modern datums
(NAD83, ETRS89, GDA94, NZGD2000, ...) are treated as WGS84-coincident (sub-meter, far below
DEM georeferencing accuracy).

Formulas: Karney 2011 (transverse Mercator), Snyder 1987 "Map Projections - A Working Manual"
(LCC 15-1.., Albers 14-1.., LAEA 24-1.., Mercator 7-6.., polar stereographic 21-33..,
meridian arc 3-21/3-26), EPSG Guidance Note 7-2 (oblique/double stereographic 9809, Swiss
oblique Mercator 9815 azimuth-center special case).
"""

from __future__ import annotations

import logging
import math
import re
from typing import Any, Tuple

import numpy as np

_logger = logging.getLogger(__name__)

# --------------------------------------------------------------------------------------
# Ellipsoids and datums
# --------------------------------------------------------------------------------------

# name -> (a, f). f stored directly (not 1/f); 0.0 means sphere.
ELLIPSOIDS: dict[str, tuple[float, float]] = {
    "WGS84": (6378137.0, 1.0 / 298.257223563),
    "GRS80": (6378137.0, 1.0 / 298.257222101),
    "intl": (6378388.0, 1.0 / 297.0),                    # International 1924 (Hayford)
    "clrk66": (6378206.4, 1.0 / 294.9786982139006),      # Clarke 1866
    "clrk80ign": (6378249.2, 1.0 / 293.4660212936269),   # Clarke 1880 (IGN)
    "airy": (6377563.396, 1.0 / 299.3249646),            # Airy 1830
    "mod_airy": (6377340.189, 1.0 / 299.3249646),        # Airy Modified 1849
    "bessel": (6377397.155, 1.0 / 299.1528128),          # Bessel 1841
    "krass": (6378245.0, 1.0 / 298.3),                   # Krassowsky 1940
    "WGS72": (6378135.0, 1.0 / 298.26),
    "GRS67": (6378160.0, 1.0 / 298.247167427),
    "aust_SA": (6378160.0, 1.0 / 298.25),                # Australian National / SAD69
    "hughes": (6378273.0, (6378273.0 - 6356889.449) / 6378273.0),  # Hughes 1980 (NSIDC)
    "sphere": (6370997.0, 0.0),                          # Authalic sphere (US Atlas)
}

# datum name -> towgs84 (position vector; 3-tuples padded with zeros at normalization)
DATUMS: dict[str, tuple[float, ...]] = {
    "WGS84": (0.0, 0.0, 0.0),
    "ED50": (-87.0, -98.0, -121.0),                      # European mean 3-param
    "NTF": (-168.0, -60.0, 320.0),
    "NAD27": (-8.0, 160.0, 176.0),                       # Conus mean 3-param
    "OSGB36": (446.448, -125.157, 542.06, 0.1502, 0.247, 0.8421, -20.4894),
    "WGS72": (0.0, 0.0, 4.5, 0.0, 0.0, 0.554, 0.2263),
    "DHDN": (598.1, 73.7, 418.2, 0.202, 0.045, -2.455, 6.7),   # Potsdam
    "CH1903": (674.374, 15.056, 405.346),
    "CH1903+": (674.374, 15.056, 405.346),
    "Amersfoort": (565.417, 50.3319, 465.552, -0.398957, 0.343988, -1.8774, 4.0725),
    "TM75": (482.5, -130.6, 564.6, -1.042, -0.214, -0.631, 8.15),  # Ireland 1965/1975
    "S42RO": (28.0, -121.0, -77.0),                      # Pulkovo 1942(58) Romania
    "NZGD49": (59.47, -5.04, 187.44, 0.47, -0.1, 1.024, -4.5993),
    "SAD69": (-57.0, 1.0, -41.0),
}

_ARCSEC = math.pi / 648000.0


def _ell_consts(p: dict) -> dict:
    """Ellipsoid constants from a projdef carrying either 'ellps' (name) or 'a'/'f'."""
    if "a" in p:
        a, f = float(p["a"]), float(p.get("f", 0.0))
    else:
        a, f = ELLIPSOIDS[p["ellps"]]
    e2 = f * (2.0 - f)
    return {"a": a, "f": f, "e": math.sqrt(e2), "e2": e2}


def _helmert_matrices(towgs84: tuple[float, ...]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(M, M_inv, T) for X_wgs = M @ X_local + T (position-vector convention)."""
    dx, dy, dz, rx, ry, rz, ds = (tuple(towgs84) + (0.0,) * 7)[:7]
    rx, ry, rz = rx * _ARCSEC, ry * _ARCSEC, rz * _ARCSEC
    s = 1.0 + ds * 1e-6
    m = s * np.array([[1.0, -rz, ry], [rz, 1.0, -rx], [-ry, rx, 1.0]])
    return m, np.linalg.inv(m), np.array([dx, dy, dz])


def _geodetic_to_ecef(lon, lat, ell: dict, xp: Any = np):
    lam = xp.deg2rad(lon)
    phi = xp.deg2rad(lat)
    n = ell["a"] / xp.sqrt(1 - ell["e2"] * xp.sin(phi) ** 2)
    x = n * xp.cos(phi) * xp.cos(lam)
    y = n * xp.cos(phi) * xp.sin(lam)
    z = n * (1 - ell["e2"]) * xp.sin(phi)
    return x, y, z


def _ecef_to_geodetic(x, y, z, ell: dict, xp: Any = np):
    lam = xp.arctan2(y, x)
    pr = xp.sqrt(x * x + y * y)
    phi = xp.arctan2(z, pr * (1 - ell["e2"]))
    for _ in range(5):
        n = ell["a"] / xp.sqrt(1 - ell["e2"] * xp.sin(phi) ** 2)
        h = pr / xp.cos(phi) - n
        phi = xp.arctan2(z, pr * (1 - ell["e2"] * n / (n + h)))
    return xp.rad2deg(lam), xp.rad2deg(phi)


def helmert_shift(lon, lat, towgs84: tuple[float, ...], ell: dict, to_wgs84: bool, xp: Any = np):
    """Helmert (3- or 7-parameter, position vector) between a datum and WGS84.

    Points are taken on the source ellipsoid surface (h=0), transformed in ECEF, and
    converted back on the target ellipsoid — the standard h=0 approximation for 2-D CRS work
    (vertical handling lives in vcrs.py). Matches reference pyproj usage for horizontal CRS.
    """
    m, m_inv, t = _helmert_matrices(towgs84)
    wgs = {"a": ELLIPSOIDS["WGS84"][0], "f": ELLIPSOIDS["WGS84"][1]}
    wgs = {**wgs, "e2": wgs["f"] * (2 - wgs["f"])}
    if to_wgs84:
        x, y, z = _geodetic_to_ecef(lon, lat, ell, xp=xp)
        xw = m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + t[0]
        yw = m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + t[1]
        zw = m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + t[2]
        return _ecef_to_geodetic(xw, yw, zw, wgs, xp=xp)
    x, y, z = _geodetic_to_ecef(lon, lat, wgs, xp=xp)
    xs, ys, zs = x - t[0], y - t[1], z - t[2]
    xl = m_inv[0, 0] * xs + m_inv[0, 1] * ys + m_inv[0, 2] * zs
    yl = m_inv[1, 0] * xs + m_inv[1, 1] * ys + m_inv[1, 2] * zs
    zl = m_inv[2, 0] * xs + m_inv[2, 1] * ys + m_inv[2, 2] * zs
    return _ecef_to_geodetic(xl, yl, zl, ell, xp=xp)


# --------------------------------------------------------------------------------------
# Shared ellipsoidal helper functions (Snyder)
# --------------------------------------------------------------------------------------


def _m_snyder(lat, e, xp):
    return xp.cos(lat) / xp.sqrt(1 - (e * xp.sin(lat)) ** 2)


def _t_snyder(lat, e, xp):
    return xp.tan(xp.pi / 4 - lat / 2) / ((1 - e * xp.sin(lat)) / (1 + e * xp.sin(lat))) ** (e / 2)


def _lat_from_t(t, e, xp):
    """Invert t(lat) (Snyder eq. 7-9, fixed-point; converges quadratically for |e|<0.1)."""
    lat = xp.pi / 2 - 2 * xp.arctan(t)
    for _ in range(6):
        lat = xp.pi / 2 - 2 * xp.arctan(t * ((1 - e * xp.sin(lat)) / (1 + e * xp.sin(lat))) ** (e / 2))
    return lat


def _q_snyder(lat, e, xp):
    if e == 0.0:  # sphere: q -> 2 sin(lat)
        return 2.0 * xp.sin(lat)
    s = xp.sin(lat)
    return (1 - e * e) * (s / (1 - (e * s) ** 2) - (1 / (2 * e)) * xp.log((1 - e * s) / (1 + e * s)))


def _lat_from_q(q, e, e2, xp):
    """Latitude from the Albers/LAEA/CEA authalic q (Snyder eq. 3-16 iteration)."""
    if e == 0.0:
        return xp.arcsin(xp.clip(q / 2.0, -1.0, 1.0))
    qp = _q_snyder(math.pi / 2, e, np)
    lat = xp.arcsin(xp.clip(q / 2, -1, 1))
    for _ in range(6):
        s = xp.sin(lat)
        lat = lat + ((1 - (e * s) ** 2) ** 2 / (2 * xp.cos(lat))) * (
            q / (1 - e2) - s / (1 - (e * s) ** 2) + (1 / (2 * e)) * xp.log((1 - e * s) / (1 + e * s))
        )
    # Poles: q == +-qp maps exactly to +-90 deg; the iteration above divides by cos(lat)
    lat = xp.where(xp.abs(xp.abs(q) - qp) < 1e-12, xp.sign(q) * (xp.pi / 2), lat)
    return lat


def _meridian_arc(lat, a, e2, xp):
    """Meridian arc length from the equator (Snyder eq. 3-21)."""
    e4, e6 = e2 * e2, e2 * e2 * e2
    return a * (
        (1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * lat
        - (3 * e2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024) * xp.sin(2 * lat)
        + (15 * e4 / 256 + 45 * e6 / 1024) * xp.sin(4 * lat)
        - (35 * e6 / 3072) * xp.sin(6 * lat)
    )


def _lat_from_meridian_arc(m, a, e2, xp):
    """Footpoint latitude from meridian arc (Snyder eqs. 3-24, 3-26)."""
    e4, e6 = e2 * e2, e2 * e2 * e2
    mu = m / (a * (1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256))
    e1 = (1 - math.sqrt(1 - e2)) / (1 + math.sqrt(1 - e2))
    return (
        mu
        + (3 * e1 / 2 - 27 * e1**3 / 32) * xp.sin(2 * mu)
        + (21 * e1**2 / 16 - 55 * e1**4 / 32) * xp.sin(4 * mu)
        + (151 * e1**3 / 96) * xp.sin(6 * mu)
        + (1097 * e1**4 / 512) * xp.sin(8 * mu)
    )


# --------------------------------------------------------------------------------------
# Transverse Mercator (Karney/Krueger series, order 6)
# --------------------------------------------------------------------------------------


def _tm_series(a: float, f: float) -> dict[str, Any]:
    n = f / (2.0 - f)
    n2, n3, n4, n5, n6 = n**2, n**3, n**4, n**5, n**6
    A = a / (1 + n) * (1 + n2 / 4 + n4 / 64 + n6 / 256)
    alpha = np.array(
        [
            n / 2 - 2 * n2 / 3 + 5 * n3 / 16 + 41 * n4 / 180 - 127 * n5 / 288 + 7891 * n6 / 37800,
            13 * n2 / 48 - 3 * n3 / 5 + 557 * n4 / 1440 + 281 * n5 / 630 - 1983433 * n6 / 1935360,
            61 * n3 / 240 - 103 * n4 / 140 + 15061 * n5 / 26880 + 167603 * n6 / 181440,
            49561 * n4 / 161280 - 179 * n5 / 168 + 6601661 * n6 / 7257600,
            34729 * n5 / 80640 - 3418889 * n6 / 1995840,
            212378941 * n6 / 319334400,
        ]
    )
    beta = np.array(
        [
            n / 2 - 2 * n2 / 3 + 37 * n3 / 96 - n4 / 360 - 81 * n5 / 512 + 96199 * n6 / 604800,
            n2 / 48 + n3 / 15 - 437 * n4 / 1440 + 46 * n5 / 105 - 1118711 * n6 / 3870720,
            17 * n3 / 480 - 37 * n4 / 840 - 209 * n5 / 4480 + 5569 * n6 / 90720,
            4397 * n4 / 161280 - 11 * n5 / 504 - 830251 * n6 / 7257600,
            4583 * n5 / 161280 - 108847 * n6 / 3991680,
            20648693 * n6 / 638668800,
        ]
    )
    e2 = f * (2 - f)
    return {"A": A, "alpha": alpha, "beta": beta, "e": math.sqrt(e2), "a": a, "f": f}


_TM_CACHE: dict[tuple[float, float], dict] = {}


def _tm_consts(a: float, f: float) -> dict:
    key = (a, f)
    if key not in _TM_CACHE:
        _TM_CACHE[key] = _tm_series(a, f)
    return _TM_CACHE[key]


def tm_forward(lon_deg, lat_deg, p: dict, xp: Any = np):
    """Transverse Mercator forward (mm accuracy within ~30 deg of the central meridian)."""
    ell = _ell_consts(p)
    c = _tm_consts(ell["a"], ell["f"])
    e, A, alpha = c["e"], c["A"], c["alpha"]
    k0 = p.get("k_0", 1.0)
    lat = xp.deg2rad(lat_deg)
    lon = xp.deg2rad(lon_deg - p.get("lon_0", 0.0))
    t = xp.sinh(xp.arctanh(xp.sin(lat)) - e * xp.arctanh(e * xp.sin(lat)))
    xi_p = xp.arctan2(t, xp.cos(lon))
    eta_p = xp.arcsinh(xp.sin(lon) / xp.sqrt(t * t + xp.cos(lon) ** 2))
    xi = xi_p
    eta = eta_p
    for j in range(6):
        xi = xi + alpha[j] * xp.sin(2 * (j + 1) * xi_p) * xp.cosh(2 * (j + 1) * eta_p)
        eta = eta + alpha[j] * xp.cos(2 * (j + 1) * xi_p) * xp.sinh(2 * (j + 1) * eta_p)
    # lat_0 enters through the meridian-arc offset (M0 == A*xi at lat_0 for the series)
    m0 = _tm_rectified_origin(p, c)
    return p.get("x_0", 0.0) + k0 * A * eta, p.get("y_0", 0.0) + k0 * (A * xi - m0)


def _tm_rectified_origin(p: dict, c: dict) -> float:
    lat0 = p.get("lat_0", 0.0)
    if lat0 == 0.0:
        return 0.0
    e, A, alpha = c["e"], c["A"], c["alpha"]
    lat = math.radians(lat0)
    t = math.sinh(math.atanh(math.sin(lat)) - e * math.atanh(e * math.sin(lat)))
    xi_p = math.atan2(t, 1.0)
    xi = xi_p
    for j in range(6):
        xi += alpha[j] * math.sin(2 * (j + 1) * xi_p)
    return A * xi


def tm_inverse(x, y, p: dict, xp: Any = np):
    ell = _ell_consts(p)
    c = _tm_consts(ell["a"], ell["f"])
    e, A, beta = c["e"], c["A"], c["beta"]
    k0 = p.get("k_0", 1.0)
    m0 = _tm_rectified_origin(p, c)
    xi = (y - p.get("y_0", 0.0) + k0 * m0) / (k0 * A)
    eta = (x - p.get("x_0", 0.0)) / (k0 * A)
    xi_p = xi
    eta_p = eta
    for j in range(6):
        xi_p = xi_p - beta[j] * xp.sin(2 * (j + 1) * xi) * xp.cosh(2 * (j + 1) * eta)
        eta_p = eta_p - beta[j] * xp.cos(2 * (j + 1) * xi) * xp.sinh(2 * (j + 1) * eta)
    s = xp.sinh(eta_p)
    lon = xp.arctan2(s, xp.cos(xi_p))
    tau_p = xp.sin(xi_p) / xp.sqrt(s * s + xp.cos(xi_p) ** 2)
    tau = tau_p
    for _ in range(4):
        sigma = xp.sinh(e * xp.arctanh(e * tau / xp.sqrt(1 + tau * tau)))
        f_tau = tau * xp.sqrt(1 + sigma * sigma) - sigma * xp.sqrt(1 + tau * tau) - tau_p
        df = (xp.sqrt((1 + sigma * sigma) * (1 + tau * tau)) - sigma * tau) * (1 - e * e) * xp.sqrt(
            1 + tau * tau
        ) / (1 + (1 - e * e) * tau * tau)
        tau = tau - f_tau / df
    lat = xp.arctan(tau)
    return xp.rad2deg(lon) + p.get("lon_0", 0.0), xp.rad2deg(lat)


# --------------------------------------------------------------------------------------
# Mercator family
# --------------------------------------------------------------------------------------


def merc_forward(lon, lat, p: dict, xp: Any = np):
    """Ellipsoidal Mercator, variant A (k_0) or B (lat_ts). Snyder eqs. 7-6..7-8."""
    c = _ell_consts(p)
    e = c["e"]
    if "lat_ts" in p:
        k0 = float(_m_snyder(math.radians(p["lat_ts"]), e, math))
    else:
        k0 = p.get("k_0", 1.0)
    x = p.get("x_0", 0.0) + c["a"] * k0 * xp.deg2rad(lon - p.get("lon_0", 0.0))
    y = p.get("y_0", 0.0) - c["a"] * k0 * xp.log(_t_snyder(xp.deg2rad(lat), e, xp))
    return x, y


def merc_inverse(x, y, p: dict, xp: Any = np):
    c = _ell_consts(p)
    e = c["e"]
    if "lat_ts" in p:
        k0 = float(_m_snyder(math.radians(p["lat_ts"]), e, math))
    else:
        k0 = p.get("k_0", 1.0)
    t = xp.exp(-(y - p.get("y_0", 0.0)) / (c["a"] * k0))
    lat = _lat_from_t(t, e, xp)
    lon = p.get("lon_0", 0.0) + xp.rad2deg((x - p.get("x_0", 0.0)) / (c["a"] * k0))
    return lon, xp.rad2deg(lat)


def webmerc_forward(lon, lat, p: dict, xp: Any = np):
    """Spherical Web Mercator on the WGS84 semi-major axis (EPSG method 1024)."""
    a = _ell_consts(p)["a"]
    x = p.get("x_0", 0.0) + a * xp.deg2rad(lon - p.get("lon_0", 0.0))
    y = p.get("y_0", 0.0) + a * xp.log(xp.tan(xp.pi / 4 + xp.deg2rad(lat) / 2))
    return x, y


def webmerc_inverse(x, y, p: dict, xp: Any = np):
    a = _ell_consts(p)["a"]
    lon = p.get("lon_0", 0.0) + xp.rad2deg((x - p.get("x_0", 0.0)) / a)
    lat = xp.rad2deg(2 * xp.arctan(xp.exp((y - p.get("y_0", 0.0)) / a)) - xp.pi / 2)
    return lon, lat


# --------------------------------------------------------------------------------------
# Lambert conformal conic (1SP and 2SP)
# --------------------------------------------------------------------------------------


def _lcc_consts(p: dict) -> dict:
    ell = _ell_consts(p)
    e = ell["e"]
    lat0 = math.radians(p["lat_0"])
    t0 = float(_t_snyder(lat0, e, np))
    if p.get("proj") == "lcc1sp" or "lat_1" not in p:
        n = math.sin(lat0)
        m0 = float(_m_snyder(lat0, e, np))
        F = p.get("k_0", 1.0) * m0 / (n * t0**n)
    else:
        lat1 = math.radians(p["lat_1"])
        lat2 = math.radians(p.get("lat_2", p["lat_1"]))
        m1 = float(_m_snyder(lat1, e, np))
        t1 = float(_t_snyder(lat1, e, np))
        if abs(lat2 - lat1) < 1e-12:
            n = math.sin(lat1)
        else:
            m2 = float(_m_snyder(lat2, e, np))
            t2 = float(_t_snyder(lat2, e, np))
            n = (math.log(m1) - math.log(m2)) / (math.log(t1) - math.log(t2))
        F = m1 / (n * t1**n)
    rho0 = ell["a"] * F * t0**n
    return {**ell, "n": n, "F": F, "rho0": rho0}


def lcc_forward(lon, lat, p: dict, xp: Any = np):
    c = _lcc_consts(p)
    t = _t_snyder(xp.deg2rad(lat), c["e"], xp)
    rho = c["a"] * c["F"] * xp.sign(c["n"]) * xp.abs(t) ** c["n"]
    theta = c["n"] * xp.deg2rad(lon - p["lon_0"])
    x = p.get("x_0", 0.0) + rho * xp.sin(theta)
    y = p.get("y_0", 0.0) + c["rho0"] - rho * xp.cos(theta)
    return x, y


def lcc_inverse(x, y, p: dict, xp: Any = np):
    c = _lcc_consts(p)
    xs = x - p.get("x_0", 0.0)
    ys = c["rho0"] - (y - p.get("y_0", 0.0))
    sgn = 1.0 if c["n"] >= 0 else -1.0
    rho = sgn * xp.sqrt(xs * xs + ys * ys)
    theta = xp.arctan2(sgn * xs, sgn * ys)
    t = (rho / (c["a"] * c["F"])) ** (1.0 / c["n"])
    lat = _lat_from_t(t, c["e"], xp)
    return xp.rad2deg(theta / c["n"]) + p["lon_0"], xp.rad2deg(lat)


# --------------------------------------------------------------------------------------
# Albers equal area
# --------------------------------------------------------------------------------------


def _aea_consts(p: dict) -> dict:
    ell = _ell_consts(p)
    e = ell["e"]
    lat0 = math.radians(p.get("lat_0", 0.0))
    lat1 = math.radians(p["lat_1"])
    lat2 = math.radians(p.get("lat_2", p["lat_1"]))
    m1 = float(_m_snyder(lat1, e, np))
    q0 = float(_q_snyder(lat0, e, np))
    q1 = float(_q_snyder(lat1, e, np))
    if abs(lat2 - lat1) < 1e-12:
        n = math.sin(lat1)
    else:
        m2 = float(_m_snyder(lat2, e, np))
        q2 = float(_q_snyder(lat2, e, np))
        n = (m1**2 - m2**2) / (q2 - q1)
    C = m1**2 + n * q1
    rho0 = ell["a"] * math.sqrt(C - n * q0) / n
    return {**ell, "n": n, "C": C, "rho0": rho0}


def aea_forward(lon, lat, p: dict, xp: Any = np):
    c = _aea_consts(p)
    q = _q_snyder(xp.deg2rad(lat), c["e"], xp)
    rho = c["a"] * xp.sqrt(c["C"] - c["n"] * q) / c["n"]
    theta = c["n"] * xp.deg2rad(lon - p["lon_0"])
    x = p.get("x_0", 0.0) + rho * xp.sin(theta)
    y = p.get("y_0", 0.0) + c["rho0"] - rho * xp.cos(theta)
    return x, y


def aea_inverse(x, y, p: dict, xp: Any = np):
    c = _aea_consts(p)
    xs = x - p.get("x_0", 0.0)
    ys = c["rho0"] - (y - p.get("y_0", 0.0))
    sgn = 1.0 if c["n"] >= 0 else -1.0
    rho = sgn * xp.sqrt(xs * xs + ys * ys)
    theta = xp.arctan2(sgn * xs, sgn * ys)
    q = (c["C"] - (rho * c["n"] / c["a"]) ** 2) / c["n"]
    lat = _lat_from_q(q, c["e"], c["e2"], xp)
    return xp.rad2deg(theta / c["n"]) + p["lon_0"], xp.rad2deg(lat)


# --------------------------------------------------------------------------------------
# Lambert azimuthal equal area (oblique + polar; EPSG method 9820)
# --------------------------------------------------------------------------------------


def _laea_consts(p: dict) -> dict:
    ell = _ell_consts(p)
    e = ell["e"]
    qp = float(_q_snyder(math.pi / 2, e, np))
    lat0 = math.radians(p.get("lat_0", 0.0))
    polar = abs(abs(p.get("lat_0", 0.0)) - 90.0) < 1e-9
    c = {**ell, "qp": qp, "polar": polar, "sgn": 1.0 if p.get("lat_0", 0.0) >= 0 else -1.0}
    if not polar:
        q0 = float(_q_snyder(lat0, e, np))
        beta0 = math.asin(min(max(q0 / qp, -1.0), 1.0))
        rq = ell["a"] * math.sqrt(qp / 2.0)
        m0 = float(_m_snyder(lat0, e, np))
        d = ell["a"] * m0 / (rq * math.cos(beta0)) if abs(math.cos(beta0)) > 1e-15 else 1.0
        c.update({"beta0": beta0, "rq": rq, "d": d})
    return c


def laea_forward(lon, lat, p: dict, xp: Any = np):
    c = _laea_consts(p)
    lam = xp.deg2rad(lon - p.get("lon_0", 0.0))
    q = _q_snyder(xp.deg2rad(lat), c["e"], xp)
    x0, y0 = p.get("x_0", 0.0), p.get("y_0", 0.0)
    if c["polar"]:
        sgn = c["sgn"]
        rho = c["a"] * xp.sqrt(xp.maximum(c["qp"] - sgn * q, 0.0))
        x = x0 + rho * xp.sin(lam)
        y = y0 - sgn * rho * xp.cos(lam)
        return x, y
    beta = xp.arcsin(xp.clip(q / c["qp"], -1.0, 1.0))
    b = c["rq"] * xp.sqrt(
        2.0 / (1 + math.sin(c["beta0"]) * xp.sin(beta) + math.cos(c["beta0"]) * xp.cos(beta) * xp.cos(lam))
    )
    x = x0 + b * c["d"] * xp.cos(beta) * xp.sin(lam)
    y = y0 + (b / c["d"]) * (math.cos(c["beta0"]) * xp.sin(beta) - math.sin(c["beta0"]) * xp.cos(beta) * xp.cos(lam))
    return x, y


def laea_inverse(x, y, p: dict, xp: Any = np):
    c = _laea_consts(p)
    xs = x - p.get("x_0", 0.0)
    ys = y - p.get("y_0", 0.0)
    if c["polar"]:
        sgn = c["sgn"]
        rho = xp.sqrt(xs * xs + ys * ys)
        q = sgn * (c["qp"] - (rho / c["a"]) ** 2)
        lat = _lat_from_q(q, c["e"], c["e2"], xp)
        lam = xp.arctan2(xs, -sgn * ys)
        return xp.rad2deg(lam) + p.get("lon_0", 0.0), xp.rad2deg(lat)
    d = c["d"]
    rho = xp.sqrt((xs / d) ** 2 + (d * ys) ** 2)
    safe_rho = xp.where(rho > 1e-12, rho, 1.0)
    ce = 2 * xp.arcsin(xp.clip(safe_rho / (2 * c["rq"]), -1.0, 1.0))
    q = c["qp"] * (xp.cos(ce) * math.sin(c["beta0"]) + d * ys * xp.sin(ce) * math.cos(c["beta0"]) / safe_rho)
    q = xp.where(rho > 1e-12, q, c["qp"] * math.sin(c["beta0"]))
    lat = _lat_from_q(q, c["e"], c["e2"], xp)
    lam = xp.arctan2(
        xs * xp.sin(ce),
        d * safe_rho * math.cos(c["beta0"]) * xp.cos(ce) - d * d * ys * math.sin(c["beta0"]) * xp.sin(ce),
    )
    lam = xp.where(rho > 1e-12, lam, 0.0)
    return xp.rad2deg(lam) + p.get("lon_0", 0.0), xp.rad2deg(lat)


# --------------------------------------------------------------------------------------
# Polar stereographic (variants A: k_0 at the pole; B: lat_ts; Snyder 21-33..21-34)
# --------------------------------------------------------------------------------------


def _stere_polar_consts(p: dict) -> dict:
    ell = _ell_consts(p)
    e = ell["e"]
    sgn = 1.0 if p["lat_0"] >= 0 else -1.0
    if "lat_ts" in p and abs(abs(p["lat_ts"]) - 90.0) > 1e-9:
        lat_ts = math.radians(abs(p["lat_ts"]))
        t_c = math.tan(math.pi / 4 - lat_ts / 2) / (
            (1 - e * math.sin(lat_ts)) / (1 + e * math.sin(lat_ts))
        ) ** (e / 2)
        m_c = math.cos(lat_ts) / math.sqrt(1 - (e * math.sin(lat_ts)) ** 2)
        factor = m_c / t_c  # rho = a * factor * t
    else:
        k0 = p.get("k_0", 1.0)
        factor = 2 * k0 / math.sqrt((1 + e) ** (1 + e) * (1 - e) ** (1 - e))
    return {**ell, "sgn": sgn, "factor": factor}


def stere_polar_forward(lon, lat, p: dict, xp: Any = np):
    c = _stere_polar_consts(p)
    e, sgn = c["e"], c["sgn"]
    lat_r = xp.deg2rad(lat * sgn)
    lon_r = xp.deg2rad((lon - p.get("lon_0", 0.0)) * sgn)
    t = _t_snyder(lat_r, e, xp)
    rho = c["a"] * c["factor"] * t
    x = p.get("x_0", 0.0) + sgn * rho * xp.sin(lon_r)
    y = p.get("y_0", 0.0) - sgn * rho * xp.cos(lon_r)
    return x, y


def stere_polar_inverse(x, y, p: dict, xp: Any = np):
    c = _stere_polar_consts(p)
    e, sgn = c["e"], c["sgn"]
    xs = (x - p.get("x_0", 0.0)) * sgn
    ys = (y - p.get("y_0", 0.0)) * sgn
    rho = xp.sqrt(xs * xs + ys * ys)
    t = rho / (c["a"] * c["factor"])
    lat_r = _lat_from_t(t, e, xp)
    lon_r = xp.arctan2(xs, -ys)
    return xp.rad2deg(lon_r) * sgn + p.get("lon_0", 0.0), xp.rad2deg(lat_r) * sgn


# --------------------------------------------------------------------------------------
# Oblique (double) stereographic — EPSG method 9809 (e.g. Amersfoort / RD New)
# --------------------------------------------------------------------------------------


def _sterea_consts(p: dict) -> dict:
    ell = _ell_consts(p)
    a, e, e2 = ell["a"], ell["e"], ell["e2"]
    lat0 = math.radians(p["lat_0"])
    s0 = math.sin(lat0)
    rho0 = a * (1 - e2) / (1 - e2 * s0 * s0) ** 1.5
    nu0 = a / math.sqrt(1 - e2 * s0 * s0)
    R = math.sqrt(rho0 * nu0)
    n = math.sqrt(1 + (e2 * math.cos(lat0) ** 4) / (1 - e2))
    s1 = (1 + s0) / (1 - s0)
    s2 = (1 - e * s0) / (1 + e * s0)
    w1 = (s1 * s2**e) ** n
    sin_chi0 = (w1 - 1) / (w1 + 1)
    c = (n + s0) * (1 - sin_chi0) / ((n - s0) * (1 + sin_chi0))
    w2 = c * w1
    chi0 = math.asin((w2 - 1) / (w2 + 1))
    return {**ell, "R": R, "n": n, "c": c, "chi0": chi0, "lat0": lat0}


def sterea_forward(lon, lat, p: dict, xp: Any = np):
    c = _sterea_consts(p)
    e, n, R, chi0 = c["e"], c["n"], c["R"], c["chi0"]
    k0 = p.get("k_0", 1.0)
    lam0 = math.radians(p["lon_0"])
    phi = xp.deg2rad(lat)
    lam = xp.deg2rad(lon)
    big_l = n * (lam - lam0) + lam0
    sa = (1 + xp.sin(phi)) / (1 - xp.sin(phi))
    sb = (1 - e * xp.sin(phi)) / (1 + e * xp.sin(phi))
    w = c["c"] * (sa * sb**e) ** n
    chi = xp.arcsin((w - 1) / (w + 1))
    b = 1 + xp.sin(chi) * math.sin(chi0) + xp.cos(chi) * math.cos(chi0) * xp.cos(big_l - lam0)
    x = p.get("x_0", 0.0) + 2 * R * k0 * xp.cos(chi) * xp.sin(big_l - lam0) / b
    y = p.get("y_0", 0.0) + 2 * R * k0 * (xp.sin(chi) * math.cos(chi0) - xp.cos(chi) * math.sin(chi0) * xp.cos(big_l - lam0)) / b
    return x, y


def sterea_inverse(x, y, p: dict, xp: Any = np):
    c = _sterea_consts(p)
    e, n, R, chi0 = c["e"], c["n"], c["R"], c["chi0"]
    k0 = p.get("k_0", 1.0)
    lam0 = math.radians(p["lon_0"])
    xs = x - p.get("x_0", 0.0)
    ys = y - p.get("y_0", 0.0)
    g = 2 * R * k0 * math.tan(math.pi / 4 - chi0 / 2)
    h = 4 * R * k0 * math.tan(chi0) + g
    i = xp.arctan2(xs, h + ys)
    j = xp.arctan2(xs, g - ys) - i
    chi = chi0 + 2 * xp.arctan((ys - xs * xp.tan(j / 2)) / (2 * R * k0))
    big_l = j + 2 * i + lam0
    lam = (big_l - lam0) / n + lam0
    # Isometric latitude from chi, then iterate to geodetic latitude
    psi = 0.5 * xp.log((1 + xp.sin(chi)) / (c["c"] * (1 - xp.sin(chi)))) / n
    phi = 2 * xp.arctan(xp.exp(psi)) - xp.pi / 2
    for _ in range(5):
        psi_i = xp.log(xp.tan(phi / 2 + xp.pi / 4) * ((1 - e * xp.sin(phi)) / (1 + e * xp.sin(phi))) ** (e / 2))
        phi = phi - (psi_i - psi) * xp.cos(phi) * (1 - e * e * xp.sin(phi) ** 2) / (1 - e * e)
    return xp.rad2deg(lam), xp.rad2deg(phi)


# --------------------------------------------------------------------------------------
# Swiss oblique Mercator — EPSG method 9815 azimuth-center special case (CH1903 / LV03+95)
# --------------------------------------------------------------------------------------


def _somerc_consts(p: dict) -> dict:
    ell = _ell_consts(p)
    a, e, e2 = ell["a"], ell["e"], ell["e2"]
    lat0 = math.radians(p["lat_0"])
    s0 = math.sin(lat0)
    R = a * math.sqrt(1 - e2) / (1 - e2 * s0 * s0)
    alpha = math.sqrt(1 + (e2 / (1 - e2)) * math.cos(lat0) ** 4)
    b0 = math.asin(s0 / alpha)
    K = (
        math.log(math.tan(math.pi / 4 + b0 / 2))
        - alpha * math.log(math.tan(math.pi / 4 + lat0 / 2))
        + (alpha * e / 2) * math.log((1 + e * s0) / (1 - e * s0))
    )
    return {**ell, "R": R, "alpha": alpha, "b0": b0, "K": K}


def somerc_forward(lon, lat, p: dict, xp: Any = np):
    c = _somerc_consts(p)
    e, alpha, b0, K, R = c["e"], c["alpha"], c["b0"], c["K"], c["R"]
    k0 = p.get("k_0", 1.0)
    phi = xp.deg2rad(lat)
    s_big = alpha * xp.log(xp.tan(xp.pi / 4 + phi / 2)) - (alpha * e / 2) * xp.log(
        (1 + e * xp.sin(phi)) / (1 - e * xp.sin(phi))
    ) + K
    b = 2 * (xp.arctan(xp.exp(s_big)) - xp.pi / 4)
    ell_lon = alpha * xp.deg2rad(lon - p["lon_0"])
    b_bar = xp.arcsin(xp.clip(math.cos(b0) * xp.sin(b) - math.sin(b0) * xp.cos(b) * xp.cos(ell_lon), -1.0, 1.0))
    l_bar = xp.arctan2(xp.cos(b) * xp.sin(ell_lon), math.sin(b0) * xp.sin(b) + math.cos(b0) * xp.cos(b) * xp.cos(ell_lon))
    x = p.get("x_0", 0.0) + R * k0 * l_bar
    y = p.get("y_0", 0.0) + R * k0 * xp.log(xp.tan(xp.pi / 4 + b_bar / 2))
    return x, y


def somerc_inverse(x, y, p: dict, xp: Any = np):
    c = _somerc_consts(p)
    e, alpha, b0, K, R = c["e"], c["alpha"], c["b0"], c["K"], c["R"]
    k0 = p.get("k_0", 1.0)
    l_bar = (x - p.get("x_0", 0.0)) / (R * k0)
    b_bar = 2 * (xp.arctan(xp.exp((y - p.get("y_0", 0.0)) / (R * k0))) - xp.pi / 4)
    b = xp.arcsin(xp.clip(math.cos(b0) * xp.sin(b_bar) + math.sin(b0) * xp.cos(b_bar) * xp.cos(l_bar), -1.0, 1.0))
    ell_lon = xp.arctan2(xp.cos(b_bar) * xp.sin(l_bar), math.cos(b0) * xp.cos(b_bar) * xp.cos(l_bar) - math.sin(b0) * xp.sin(b_bar))
    lon = p["lon_0"] + xp.rad2deg(ell_lon / alpha)
    # Invert S(phi) = ln tan(pi/4 + b/2) by fixed point
    s_target = xp.log(xp.tan(xp.pi / 4 + b / 2))
    phi = b
    for _ in range(7):
        rhs = (s_target - K) / alpha + (e / 2) * xp.log((1 + e * xp.sin(phi)) / (1 - e * xp.sin(phi)))
        phi = 2 * xp.arctan(xp.exp(rhs)) - xp.pi / 2
    return lon, xp.rad2deg(phi)


# --------------------------------------------------------------------------------------
# Cylindrical equal area (EPSG 9835) and equidistant cylindrical (EPSG 1028)
# --------------------------------------------------------------------------------------


def cea_forward(lon, lat, p: dict, xp: Any = np):
    c = _ell_consts(p)
    e = c["e"]
    lat_ts = math.radians(p.get("lat_ts", 0.0))
    k0 = float(_m_snyder(lat_ts, e, math)) if e > 0 else math.cos(lat_ts)
    q = _q_snyder(xp.deg2rad(lat), e, xp)
    x = p.get("x_0", 0.0) + c["a"] * k0 * xp.deg2rad(lon - p.get("lon_0", 0.0))
    y = p.get("y_0", 0.0) + c["a"] * q / (2 * k0)
    return x, y


def cea_inverse(x, y, p: dict, xp: Any = np):
    c = _ell_consts(p)
    e = c["e"]
    lat_ts = math.radians(p.get("lat_ts", 0.0))
    k0 = float(_m_snyder(lat_ts, e, math)) if e > 0 else math.cos(lat_ts)
    q = 2 * k0 * (y - p.get("y_0", 0.0)) / c["a"]
    lat = _lat_from_q(q, e, c["e2"], xp)
    lon = p.get("lon_0", 0.0) + xp.rad2deg((x - p.get("x_0", 0.0)) / (c["a"] * k0))
    return lon, xp.rad2deg(lat)


def eqc_forward(lon, lat, p: dict, xp: Any = np):
    c = _ell_consts(p)
    lat_ts = math.radians(p.get("lat_ts", 0.0))
    nu1 = c["a"] / math.sqrt(1 - c["e2"] * math.sin(lat_ts) ** 2)
    x = p.get("x_0", 0.0) + nu1 * math.cos(lat_ts) * xp.deg2rad(lon - p.get("lon_0", 0.0))
    y = p.get("y_0", 0.0) + _meridian_arc(xp.deg2rad(lat), c["a"], c["e2"], xp)
    return x, y


def eqc_inverse(x, y, p: dict, xp: Any = np):
    c = _ell_consts(p)
    lat_ts = math.radians(p.get("lat_ts", 0.0))
    nu1 = c["a"] / math.sqrt(1 - c["e2"] * math.sin(lat_ts) ** 2)
    lat = _lat_from_meridian_arc(y - p.get("y_0", 0.0), c["a"], c["e2"], xp)
    lon = p.get("lon_0", 0.0) + xp.rad2deg((x - p.get("x_0", 0.0)) / (nu1 * math.cos(lat_ts)))
    return lon, xp.rad2deg(lat)


# --------------------------------------------------------------------------------------
# Projection dispatch
# --------------------------------------------------------------------------------------

_FORWARD = {
    "tmerc": tm_forward,
    "merc": merc_forward,
    "webmerc": webmerc_forward,
    "lcc": lcc_forward,
    "lcc1sp": lcc_forward,
    "aea": aea_forward,
    "laea": laea_forward,
    "stere": stere_polar_forward,
    "sterea": sterea_forward,
    "somerc": somerc_forward,
    "cea": cea_forward,
    "eqc": eqc_forward,
}
_INVERSE = {
    "tmerc": tm_inverse,
    "merc": merc_inverse,
    "webmerc": webmerc_inverse,
    "lcc": lcc_inverse,
    "lcc1sp": lcc_inverse,
    "aea": aea_inverse,
    "laea": laea_inverse,
    "stere": stere_polar_inverse,
    "sterea": sterea_inverse,
    "somerc": somerc_inverse,
    "cea": cea_inverse,
    "eqc": eqc_inverse,
}

SUPPORTED_PROJECTIONS = tuple(sorted(_FORWARD)) + ("longlat",)


def projdef_forward_raw(p: dict, lon, lat, xp: Any = np):
    """Own-datum geographic -> projected coordinates (NO datum shift, NO unit scaling).

    This is the bare projection kernel entry point used by control-point tests, where
    authoritative coordinates (EPSG Guidance Note 7-2 worked examples) are stated in the
    projection's own datum.
    """
    if p["proj"] == "longlat":
        return lon, lat
    return _FORWARD[p["proj"]](lon, lat, p, xp=xp)


def projdef_inverse_raw(p: dict, x, y, xp: Any = np):
    """Projected (meters) -> own-datum geographic (NO datum shift, NO unit scaling)."""
    if p["proj"] == "longlat":
        return x, y
    return _INVERSE[p["proj"]](x, y, p, xp=xp)


def projdef_to_wgs84(p: dict, x, y, xp: Any = np):
    """Projected (native units) -> WGS84 geographic."""
    tm = p.get("to_meter", 1.0)
    if tm != 1.0:
        x, y = x * tm, y * tm
    lon, lat = projdef_inverse_raw(p, x, y, xp=xp)
    tw = p.get("towgs84")
    if tw is not None and any(v != 0.0 for v in tw):
        lon, lat = helmert_shift(lon, lat, tw, _ell_consts(p), to_wgs84=True, xp=xp)
    if p["proj"] != "longlat":
        lon = (lon + 180.0) % 360.0 - 180.0  # wrap: polar inverses can leave (-180,180)
    return lon, lat


def projdef_from_wgs84(p: dict, lon, lat, xp: Any = np):
    """WGS84 geographic -> projected (native units)."""
    tw = p.get("towgs84")
    if tw is not None and any(v != 0.0 for v in tw):
        lon, lat = helmert_shift(lon, lat, tw, _ell_consts(p), to_wgs84=False, xp=xp)
    x, y = projdef_forward_raw(p, lon, lat, xp=xp)
    tm = p.get("to_meter", 1.0)
    if tm != 1.0:
        x, y = x / tm, y / tm
    return x, y

# --------------------------------------------------------------------------------------
# EPSG parameter table
# --------------------------------------------------------------------------------------
# Transcribed from the EPSG registry definitions (parameters only — a compact generated
# table for the projection families implemented above). Entries use ellps/datum names
# resolved by normalize_def(); lon_0 is always Greenwich-referenced (Paris-meridian CRSs
# carry the meridian baked in). The reference gets these via pyproj's full EPSG database
# (upstream xdem's dem.py); this table covers the families DEM work meets.

# Geographic 2D/3D codes treated as WGS84-coincident (GRS80 family: sub-meter)
GEOGRAPHIC_NOSHIFT = {
    4326, 4979,        # WGS84 2D/3D
    4258,              # ETRS89
    4269,              # NAD83
    4617, 6318,        # NAD83(CSRS), NAD83(2011)
    4283, 7844,        # GDA94, GDA2020
    4167,              # NZGD2000
    4619,              # SWEREF99
    4171,              # RGF93
    4151,              # CHTRF95
    4612, 6668,        # JGD2000, JGD2011
    4674,              # SIRGAS 2000
    4148,              # Hartebeesthoek94
}

# Geographic codes on legacy datums (Helmert applies, no projection)
_GEOGRAPHIC_DATUM_DEFS: dict[int, dict] = {
    4267: dict(proj="longlat", ellps="clrk66", datum="NAD27"),
    4230: dict(proj="longlat", ellps="intl", datum="ED50"),
    4277: dict(proj="longlat", ellps="airy", datum="OSGB36"),
    4275: dict(proj="longlat", ellps="clrk80ign", datum="NTF"),
    4322: dict(proj="longlat", ellps="WGS72", datum="WGS72"),
    4299: dict(proj="longlat", ellps="mod_airy", datum="TM75"),  # TM65
    4300: dict(proj="longlat", ellps="mod_airy", datum="TM75"),
    4314: dict(proj="longlat", ellps="bessel", datum="DHDN"),
    4289: dict(proj="longlat", ellps="bessel", datum="Amersfoort"),
    4149: dict(proj="longlat", ellps="bessel", datum="CH1903"),
    4150: dict(proj="longlat", ellps="bessel", datum="CH1903+"),
    4272: dict(proj="longlat", ellps="intl", datum="NZGD49"),
    4618: dict(proj="longlat", ellps="aust_SA", datum="SAD69"),
}

# NTF (Paris) / Lambert zones: the Paris meridian (2deg20'14.025" = 2.337229... Greenwich
# degrees) is baked into lon_0; latitudes are the grad-valued originals in degrees.
_PARIS = 2.337229166666667

_EPSG_DEFS: dict[int, dict] = {
    # ---- France (NTF, Clarke 1880 IGN, Paris meridian) ----
    27561: dict(proj="lcc1sp", lat_0=49.5, k_0=0.999877341, lon_0=_PARIS,
                x_0=600000.0, y_0=200000.0, ellps="clrk80ign", datum="NTF", name="NTF (Paris) / Lambert Nord France"),
    27562: dict(proj="lcc1sp", lat_0=46.8, k_0=0.99987742, lon_0=_PARIS,
                x_0=600000.0, y_0=200000.0, ellps="clrk80ign", datum="NTF", name="NTF (Paris) / Lambert Centre France"),
    27563: dict(proj="lcc1sp", lat_0=44.1, k_0=0.999877499, lon_0=_PARIS,
                x_0=600000.0, y_0=200000.0, ellps="clrk80ign", datum="NTF", name="NTF (Paris) / Lambert Sud France"),
    27564: dict(proj="lcc1sp", lat_0=42.165, k_0=0.99994471, lon_0=_PARIS,
                x_0=234.358, y_0=185861.369, ellps="clrk80ign", datum="NTF", name="NTF (Paris) / Lambert Corse"),
    27571: dict(proj="lcc1sp", lat_0=49.5, k_0=0.999877341, lon_0=_PARIS,
                x_0=600000.0, y_0=1200000.0, ellps="clrk80ign", datum="NTF", name="NTF (Paris) / Lambert zone I"),
    27572: dict(proj="lcc1sp", lat_0=46.8, k_0=0.99987742, lon_0=_PARIS,
                x_0=600000.0, y_0=2200000.0, ellps="clrk80ign", datum="NTF", name="NTF (Paris) / Lambert zone II"),
    27573: dict(proj="lcc1sp", lat_0=44.1, k_0=0.999877499, lon_0=_PARIS,
                x_0=600000.0, y_0=3200000.0, ellps="clrk80ign", datum="NTF", name="NTF (Paris) / Lambert zone III"),
    27574: dict(proj="lcc1sp", lat_0=42.165, k_0=0.99994471, lon_0=_PARIS,
                x_0=234.358, y_0=4185861.369, ellps="clrk80ign", datum="NTF", name="NTF (Paris) / Lambert zone IV"),
    2154: dict(proj="lcc", lat_1=49.0, lat_2=44.0, lat_0=46.5, lon_0=3.0,
               x_0=700000.0, y_0=6600000.0, ellps="GRS80", name="RGF93 / Lambert-93"),
    # ---- Great Britain / Ireland ----
    27700: dict(proj="tmerc", lat_0=49.0, lon_0=-2.0, k_0=0.9996012717,
                x_0=400000.0, y_0=-100000.0, ellps="airy", datum="OSGB36", name="OSGB36 / British National Grid"),
    29902: dict(proj="tmerc", lat_0=53.5, lon_0=-8.0, k_0=1.000035,
                x_0=200000.0, y_0=250000.0, ellps="mod_airy", datum="TM75", name="TM65 / Irish Grid"),
    29903: dict(proj="tmerc", lat_0=53.5, lon_0=-8.0, k_0=1.000035,
                x_0=200000.0, y_0=250000.0, ellps="mod_airy", datum="TM75", name="TM75 / Irish Grid"),
    2157: dict(proj="tmerc", lat_0=53.5, lon_0=-8.0, k_0=0.99982,
               x_0=600000.0, y_0=750000.0, ellps="GRS80", name="IRENET95 / Irish Transverse Mercator"),
    # ---- Central Europe ----
    31466: dict(proj="tmerc", lat_0=0.0, lon_0=6.0, k_0=1.0, x_0=2500000.0, y_0=0.0,
                ellps="bessel", datum="DHDN", name="DHDN / 3-degree Gauss-Krueger zone 2"),
    31467: dict(proj="tmerc", lat_0=0.0, lon_0=9.0, k_0=1.0, x_0=3500000.0, y_0=0.0,
                ellps="bessel", datum="DHDN", name="DHDN / 3-degree Gauss-Krueger zone 3"),
    31468: dict(proj="tmerc", lat_0=0.0, lon_0=12.0, k_0=1.0, x_0=4500000.0, y_0=0.0,
                ellps="bessel", datum="DHDN", name="DHDN / 3-degree Gauss-Krueger zone 4"),
    31469: dict(proj="tmerc", lat_0=0.0, lon_0=15.0, k_0=1.0, x_0=5500000.0, y_0=0.0,
                ellps="bessel", datum="DHDN", name="DHDN / 3-degree Gauss-Krueger zone 5"),
    21781: dict(proj="somerc", lat_0=46.95240555555556, lon_0=7.439583333333333, k_0=1.0,
                x_0=600000.0, y_0=200000.0, ellps="bessel", datum="CH1903", name="CH1903 / LV03"),
    2056: dict(proj="somerc", lat_0=46.95240555555556, lon_0=7.439583333333333, k_0=1.0,
               x_0=2600000.0, y_0=1200000.0, ellps="bessel", datum="CH1903+", name="CH1903+ / LV95"),
    28992: dict(proj="sterea", lat_0=52.15616055555555, lon_0=5.38763888888889, k_0=0.9999079,
                x_0=155000.0, y_0=463000.0, ellps="bessel", datum="Amersfoort", name="Amersfoort / RD New"),
    3844: dict(proj="sterea", lat_0=46.0, lon_0=25.0, k_0=0.99975,
               x_0=500000.0, y_0=500000.0, ellps="krass", datum="S42RO", name="Pulkovo 1942(58) / Stereo70"),
    31700: dict(proj="sterea", lat_0=46.0, lon_0=25.0, k_0=0.99975,
                x_0=500000.0, y_0=500000.0, ellps="krass", datum="S42RO", name="Dealul Piscului 1970 / Stereo 70"),
    # ---- Nordic / EU-wide ----
    3035: dict(proj="laea", lat_0=52.0, lon_0=10.0, x_0=4321000.0, y_0=3210000.0,
               ellps="GRS80", name="ETRS89-extended / LAEA Europe"),
    3067: dict(proj="tmerc", lat_0=0.0, lon_0=27.0, k_0=0.9996, x_0=500000.0, y_0=0.0,
               ellps="GRS80", name="ETRS89 / TM35FIN(E,N)"),
    3006: dict(proj="tmerc", lat_0=0.0, lon_0=15.0, k_0=0.9996, x_0=500000.0, y_0=0.0,
               ellps="GRS80", name="SWEREF99 TM"),
    2180: dict(proj="tmerc", lat_0=0.0, lon_0=19.0, k_0=0.9993, x_0=500000.0, y_0=-5300000.0,
               ellps="GRS80", name="ETRS89 / Poland CS92"),
    25833: None,  # covered by the ETRS89 UTM range family; placeholder removed in lookup
    # ---- North America ----
    3978: dict(proj="lcc", lat_1=49.0, lat_2=77.0, lat_0=49.0, lon_0=-95.0,
               x_0=0.0, y_0=0.0, ellps="GRS80", name="NAD83 / Canada Atlas Lambert"),
    5070: dict(proj="aea", lat_1=29.5, lat_2=45.5, lat_0=23.0, lon_0=-96.0,
               x_0=0.0, y_0=0.0, ellps="GRS80", name="NAD83 / Conus Albers"),
    6350: dict(proj="aea", lat_1=29.5, lat_2=45.5, lat_0=23.0, lon_0=-96.0,
               x_0=0.0, y_0=0.0, ellps="GRS80", name="NAD83(2011) / Conus Albers"),
    3338: dict(proj="aea", lat_1=55.0, lat_2=65.0, lat_0=50.0, lon_0=-154.0,
               x_0=0.0, y_0=0.0, ellps="GRS80", name="NAD83 / Alaska Albers"),
    2163: dict(proj="laea", lat_0=45.0, lon_0=-100.0, x_0=0.0, y_0=0.0,
               ellps="sphere", name="US National Atlas Equal Area"),
    # ---- Oceania / Asia ----
    3577: dict(proj="aea", lat_1=-18.0, lat_2=-36.0, lat_0=0.0, lon_0=132.0,
               x_0=0.0, y_0=0.0, ellps="GRS80", name="GDA94 / Australian Albers"),
    2193: dict(proj="tmerc", lat_0=0.0, lon_0=173.0, k_0=0.9996,
               x_0=1600000.0, y_0=10000000.0, ellps="GRS80", name="NZGD2000 / New Zealand Transverse Mercator"),
    # EPSG:27200 (NZGD49 / New Zealand Map Grid) deliberately absent: NZMG is a 6th-order
    # complex-polynomial projection a TM substitute would silently mis-place by km —
    # carried-only (raises on transform) is the honest behavior; modern NZ data uses 2193.
    3097: dict(proj="tmerc", lat_0=0.0, lon_0=123.0, k_0=0.9996, x_0=500000.0, y_0=0.0,
               ellps="GRS80", name="JGD2000 / UTM zone 51N"),
    3098: dict(proj="tmerc", lat_0=0.0, lon_0=129.0, k_0=0.9996, x_0=500000.0, y_0=0.0,
               ellps="GRS80", name="JGD2000 / UTM zone 52N"),
    3099: dict(proj="tmerc", lat_0=0.0, lon_0=135.0, k_0=0.9996, x_0=500000.0, y_0=0.0,
               ellps="GRS80", name="JGD2000 / UTM zone 53N"),
    3100: dict(proj="tmerc", lat_0=0.0, lon_0=141.0, k_0=0.9996, x_0=500000.0, y_0=0.0,
               ellps="GRS80", name="JGD2000 / UTM zone 54N"),
    3101: dict(proj="tmerc", lat_0=0.0, lon_0=147.0, k_0=0.9996, x_0=500000.0, y_0=0.0,
               ellps="GRS80", name="JGD2000 / UTM zone 55N"),
    # ---- World / polar ----
    3857: dict(proj="webmerc", ellps="WGS84", name="WGS 84 / Pseudo-Mercator"),
    3395: dict(proj="merc", k_0=1.0, lon_0=0.0, x_0=0.0, y_0=0.0, ellps="WGS84",
               name="WGS 84 / World Mercator"),
    4087: dict(proj="eqc", lat_ts=0.0, lon_0=0.0, x_0=0.0, y_0=0.0, ellps="WGS84",
               name="WGS 84 / World Equidistant Cylindrical"),
    6933: dict(proj="cea", lat_ts=30.0, lon_0=0.0, x_0=0.0, y_0=0.0, ellps="WGS84",
               name="WGS 84 / NSIDC EASE-Grid 2.0 Global"),
    6931: dict(proj="laea", lat_0=90.0, lon_0=0.0, x_0=0.0, y_0=0.0, ellps="WGS84",
               name="WGS 84 / NSIDC EASE-Grid 2.0 North"),
    6932: dict(proj="laea", lat_0=-90.0, lon_0=0.0, x_0=0.0, y_0=0.0, ellps="WGS84",
               name="WGS 84 / NSIDC EASE-Grid 2.0 South"),
    3413: dict(proj="stere", lat_0=90.0, lat_ts=70.0, lon_0=-45.0, x_0=0.0, y_0=0.0,
               ellps="WGS84", name="WGS 84 / NSIDC Sea Ice Polar Stereographic North"),
    3031: dict(proj="stere", lat_0=-90.0, lat_ts=-71.0, lon_0=0.0, x_0=0.0, y_0=0.0,
               ellps="WGS84", name="WGS 84 / Antarctic Polar Stereographic"),
    3995: dict(proj="stere", lat_0=90.0, lat_ts=71.0, lon_0=0.0, x_0=0.0, y_0=0.0,
               ellps="WGS84", name="WGS 84 / Arctic Polar Stereographic"),
    3976: dict(proj="stere", lat_0=-90.0, lat_ts=-70.0, lon_0=0.0, x_0=0.0, y_0=0.0,
               ellps="WGS84", name="WGS 84 / NSIDC Sea Ice Polar Stereographic South"),
    3411: dict(proj="stere", lat_0=90.0, lat_ts=70.0, lon_0=-45.0, x_0=0.0, y_0=0.0,
               ellps="hughes", name="NSIDC Sea Ice Polar Stereographic North (Hughes)"),
    3412: dict(proj="stere", lat_0=-90.0, lat_ts=-70.0, lon_0=0.0, x_0=0.0, y_0=0.0,
               ellps="hughes", name="NSIDC Sea Ice Polar Stereographic South (Hughes)"),
    3032: dict(proj="stere", lat_0=-90.0, lat_ts=-71.0, lon_0=70.0, x_0=6000000.0, y_0=6000000.0,
               ellps="WGS84", name="WGS 84 / Australian Antarctic Polar Stereographic"),
    5041: dict(proj="stere", lat_0=90.0, k_0=0.994, lon_0=0.0, x_0=2000000.0, y_0=2000000.0,
               ellps="WGS84", name="WGS 84 / UPS North (E,N)"),
    5042: dict(proj="stere", lat_0=-90.0, k_0=0.994, lon_0=0.0, x_0=2000000.0, y_0=2000000.0,
               ellps="WGS84", name="WGS 84 / UPS South (E,N)"),
    32661: dict(proj="stere", lat_0=90.0, k_0=0.994, lon_0=0.0, x_0=2000000.0, y_0=2000000.0,
                ellps="WGS84", name="WGS 84 / UPS North (N,E)"),
    32761: dict(proj="stere", lat_0=-90.0, k_0=0.994, lon_0=0.0, x_0=2000000.0, y_0=2000000.0,
                ellps="WGS84", name="WGS 84 / UPS South (N,E)"),
}
_EPSG_DEFS = {k: v for k, v in _EPSG_DEFS.items() if v is not None}


def _utm_def(zone: int, north: bool, ellps: str, datum: str | None = None, name: str = "") -> dict:
    d = dict(proj="tmerc", lat_0=0.0, lon_0=-183.0 + 6.0 * zone, k_0=0.9996,
             x_0=500000.0, y_0=0.0 if north else 10000000.0, ellps=ellps,
             name=name or f"UTM zone {zone}{'N' if north else 'S'}")
    if datum:
        d["datum"] = datum
    return d


def epsg_def(epsg: int) -> dict | None:
    """Projection definition (un-normalized) for an EPSG code, or None if unknown."""
    if epsg in GEOGRAPHIC_NOSHIFT:
        return dict(proj="longlat", ellps="WGS84", name=f"EPSG:{epsg}")
    if epsg in _GEOGRAPHIC_DATUM_DEFS:
        return dict(_GEOGRAPHIC_DATUM_DEFS[epsg])
    if epsg in _EPSG_DEFS:
        return dict(_EPSG_DEFS[epsg])
    # --- UTM range families ---
    if 32601 <= epsg <= 32660:
        return _utm_def(epsg - 32600, True, "WGS84", name=f"WGS 84 / UTM zone {epsg - 32600}N")
    if 32701 <= epsg <= 32760:
        return _utm_def(epsg - 32700, False, "WGS84", name=f"WGS 84 / UTM zone {epsg - 32700}S")
    if 26901 <= epsg <= 26923:  # NAD83
        return _utm_def(epsg - 26900, True, "GRS80", name=f"NAD83 / UTM zone {epsg - 26900}N")
    if 26701 <= epsg <= 26722:  # NAD27
        return _utm_def(epsg - 26700, True, "clrk66", "NAD27", f"NAD27 / UTM zone {epsg - 26700}N")
    if 25828 <= epsg <= 25838:  # ETRS89
        return _utm_def(epsg - 25800, True, "GRS80", name=f"ETRS89 / UTM zone {epsg - 25800}N")
    if 28348 <= epsg <= 28358:  # GDA94 / MGA
        return _utm_def(epsg - 28300, False, "GRS80", name=f"GDA94 / MGA zone {epsg - 28300}")
    if 23028 <= epsg <= 23038:  # ED50
        return _utm_def(epsg - 23000, True, "intl", "ED50", f"ED50 / UTM zone {epsg - 23000}N")
    if 32201 <= epsg <= 32260:  # WGS72 north
        return _utm_def(epsg - 32200, True, "WGS72", "WGS72", f"WGS 72 / UTM zone {epsg - 32200}N")
    if 32301 <= epsg <= 32360:  # WGS72 south
        return _utm_def(epsg - 32300, False, "WGS72", "WGS72", f"WGS 72 / UTM zone {epsg - 32300}S")
    # --- Pulkovo 1942 / Gauss-Kruger 6-degree zone families (Krassowsky 1940; the TM math
    # is the GN7-2-pinned tmerc kernel with k_0=1; datum: EPSG tfm 1254, 3-param) ---
    if 28404 <= epsg <= 28432:  # zone-numbered false easting (zone*1e6 + 500000)
        z = epsg - 28400
        return dict(proj="tmerc", lat_0=0.0, lon_0=6.0 * z - 3.0, k_0=1.0,
                    x_0=z * 1_000_000.0 + 500_000.0, y_0=0.0, ellps="krass",
                    datum="Pulkovo42", name=f"Pulkovo 1942 / Gauss-Kruger zone {z}")
    if 28464 <= epsg <= 28492:  # CM variants (plain 500 km false easting)
        z = epsg - 28460
        return dict(proj="tmerc", lat_0=0.0, lon_0=6.0 * z - 3.0, k_0=1.0,
                    x_0=500_000.0, y_0=0.0, ellps="krass", datum="Pulkovo42",
                    name=f"Pulkovo 1942 / Gauss-Kruger CM {int(6 * z - 3)}E")
    return None


# --------------------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------------------

_PROJ_ALIASES = {
    "longlat": "longlat", "latlong": "longlat", "latlon": "longlat", "lonlat": "longlat",
    "tmerc": "tmerc", "utm": "tmerc", "etmerc": "tmerc",
    "merc": "merc", "webmerc": "webmerc",
    "lcc": "lcc", "lcc1sp": "lcc1sp",
    "aea": "aea", "laea": "laea",
    "stere": "stere", "sterea": "sterea", "somerc": "somerc", "omerc": "omerc",
    "krovak": "krovak",
    "cea": "cea", "eqc": "eqc",
}


def normalize_def(d: dict) -> dict:
    """Resolve a raw projdef (names, aliases) into the normalized numeric form."""
    p = dict(d)
    proj = _PROJ_ALIASES.get(p.get("proj", "longlat"))
    if proj is None:
        raise NotImplementedError(
            f"Projection '{p.get('proj')}' is not supported (supported: "
            f"{', '.join(SUPPORTED_PROJECTIONS)})."
        )
    if p.get("proj") == "utm" and "zone" in p:
        # Dict front-end UTM shorthand (parse_projstring expands this for strings)
        zone = int(p.pop("zone"))
        south = bool(p.pop("south", False))
        p.setdefault("lat_0", 0.0)
        p.setdefault("lon_0", -183.0 + 6.0 * zone)
        p.setdefault("k_0", 0.9996)
        p.setdefault("x_0", 500000.0)
        p.setdefault("y_0", 10000000.0 if south else 0.0)
    p["proj"] = proj
    # Ellipsoid -> numeric
    if "a" not in p:
        a, f = ELLIPSOIDS[p.get("ellps", "WGS84")]
        p["a"], p["f"] = a, f
    else:
        p["a"] = float(p["a"])
        if "f" not in p:
            if "rf" in p:
                p["f"] = 1.0 / float(p["rf"]) if float(p["rf"]) != 0 else 0.0
            elif "b" in p:
                p["f"] = (p["a"] - float(p["b"])) / p["a"]
            else:
                p["f"] = 0.0
        else:
            p["f"] = float(p["f"])
    p.pop("rf", None)
    p.pop("b", None)
    # Datum -> towgs84 tuple (7 floats) or None
    tw = p.get("towgs84")
    if tw is None and "datum" in p:
        tw = DATUMS.get(p["datum"])
    if tw is not None:
        tw = tuple(float(v) for v in tw)
        tw = (tw + (0.0,) * 7)[:7]
        if all(v == 0.0 for v in tw):
            tw = None
    p["towgs84"] = tw
    # Prime meridian baked into lon_0
    pm = p.pop("pm", 0.0)
    if pm:
        p["lon_0"] = p.get("lon_0", 0.0) + float(pm)
    # Defaults
    if proj != "longlat":
        p.setdefault("lon_0", 0.0)
        p.setdefault("lat_0", 0.0)
        p.setdefault("x_0", 0.0)
        p.setdefault("y_0", 0.0)
    p.setdefault("to_meter", 1.0)
    for k in ("lat_0", "lon_0", "lat_1", "lat_2", "lat_ts", "k_0", "x_0", "y_0", "to_meter"):
        if k in p:
            p[k] = float(p[k])
    # Projection-family validation
    if proj in ("lcc",) and "lat_1" not in p:
        p["proj"] = "lcc1sp"
    if p["proj"] == "lcc1sp":
        p.setdefault("k_0", 1.0)
    if proj == "aea" and "lat_1" not in p:
        raise ValueError("Albers (aea) requires lat_1 (and usually lat_2).")
    if p["proj"] == "omerc" and "alpha" not in p:
        raise ValueError("Hotine oblique Mercator (omerc) requires alpha (azimuth).")
    if p["proj"] == "stere" and abs(abs(p.get("lat_0", 90.0)) - 90.0) > 1e-9:
        # PROJ's stere with a non-polar lat_0 is the OBLIQUE stereographic — a different
        # projection than the polar kernel here; silently projecting would be garbage
        raise NotImplementedError(
            f"Oblique stereographic ('stere' with lat_0={p.get('lat_0')}) is not supported; "
            f"use 'sterea' (double stereographic, EPSG method 9809) for oblique cases, or "
            f"lat_0=+-90 for polar."
        )
    if p["proj"] == "krovak":
        p.setdefault("alpha", 30.28813972222222)
        p.setdefault("lat_1", 78.5)
        p.setdefault("k_0", 0.9999)
    if "alpha" in p:
        p["alpha"] = float(p["alpha"])
    if "gamma" in p:
        p["gamma"] = float(p["gamma"])
    return p


_CANON_KEYS = ("proj", "a", "f", "lat_0", "lon_0", "lat_1", "lat_2", "lat_ts", "k_0",
               "alpha", "gamma", "x_0", "y_0", "to_meter", "towgs84")


def canonical_key(p: dict) -> tuple:
    """Hashable canonical form of a normalized projdef (floats rounded to 1e-11 relative)."""

    def _r(v):
        if isinstance(v, tuple):
            return tuple(_r(x) for x in v)
        if isinstance(v, float):
            return round(v, 11) if abs(v) < 1e3 else round(v, 6)
        return v

    return tuple((k, _r(p[k])) for k in _CANON_KEYS if p.get(k) is not None)


# --------------------------------------------------------------------------------------
# PROJ.4-string parser
# --------------------------------------------------------------------------------------

_PRIME_MERIDIANS = {
    "greenwich": 0.0, "paris": _PARIS, "lisbon": -9.131906111111112,
    "madrid": -3.687938888888889, "rome": 12.452333333333334, "bern": 7.439583333333333,
    "jakarta": 106.80771944444444, "ferro": -17.666666666666668,
    "brussels": 4.367975, "stockholm": 18.05827777777778, "athens": 23.7163375,
    "oslo": 10.722916666666666,
}

_PROJ_DATUM_NAMES = {
    "WGS84": ("WGS84", "WGS84"), "NAD83": ("GRS80", None), "NAD27": ("clrk66", "NAD27"),
    "OSGB36": ("airy", "OSGB36"), "potsdam": ("bessel", "DHDN"),
    "ire65": ("mod_airy", "TM75"), "nzgd49": ("intl", "NZGD49"),
}

_UNITS_TO_M = {"m": 1.0, "meter": 1.0, "metre": 1.0, "km": 1000.0,
               "ft": 0.3048, "us-ft": 1200.0 / 3937.0}


def parse_projstring(s: str) -> dict:
    """Parse a PROJ.4-style '+proj=... +key=value' string into an (un-normalized) projdef.

    Grid-based keys (+nadgrids, +geoidgrids) are ignored — Helmert parameters (+towgs84 or
    +datum) are used when present, matching PROJ's ballpark fallback without grid files.
    """
    raw: dict[str, str | bool] = {}
    for tok in s.split():
        tok = tok.lstrip("+")
        if not tok:
            continue
        if "=" in tok:
            k, v = tok.split("=", 1)
            raw[k] = v
        else:
            raw[tok] = True
    if "proj" not in raw:
        raise ValueError(f"Not a proj string (missing +proj=): {s!r}")
    proj = str(raw.pop("proj"))
    if proj not in _PROJ_ALIASES:
        raise NotImplementedError(
            f"+proj={proj} is not supported (supported: {', '.join(sorted(set(_PROJ_ALIASES)))})."
        )
    p: dict[str, Any] = {"proj": proj}

    # Ellipsoid / datum
    if "datum" in raw:
        name = str(raw.pop("datum"))
        if name not in _PROJ_DATUM_NAMES:
            raise NotImplementedError(f"+datum={name} is not supported.")
        ellps, datum = _PROJ_DATUM_NAMES[name]
        p["ellps"] = ellps
        if datum and datum != "WGS84":
            p["datum"] = datum
    if "ellps" in raw:
        name = str(raw.pop("ellps"))
        if name not in ELLIPSOIDS:
            raise NotImplementedError(f"+ellps={name} is not supported.")
        p["ellps"] = name
    for k in ("a", "b", "rf", "f"):
        if k in raw:
            p[k] = float(raw.pop(k))
    if "R" in raw:
        p["a"] = float(raw.pop("R"))
        p["f"] = 0.0
    if "towgs84" in raw:
        vals = tuple(float(v) for v in str(raw.pop("towgs84")).split(","))
        if len(vals) not in (3, 7):
            raise ValueError(f"+towgs84 needs 3 or 7 values, got {len(vals)}.")
        p["towgs84"] = vals

    # UTM shorthand
    if proj == "utm":
        zone = int(raw.pop("zone"))
        south = bool(raw.pop("south", False))
        p.update(lat_0=0.0, lon_0=-183.0 + 6.0 * zone, k_0=0.9996, x_0=500000.0,
                 y_0=10000000.0 if south else 0.0)
        p["proj"] = "tmerc"

    # Numeric parameters
    for src, dst in (("lat_0", "lat_0"), ("lon_0", "lon_0"), ("lat_1", "lat_1"),
                     ("lat_2", "lat_2"), ("lat_ts", "lat_ts"), ("k_0", "k_0"), ("k", "k_0"),
                     ("x_0", "x_0"), ("y_0", "y_0")):
        if src in raw:
            p[dst] = float(raw.pop(src))

    # LCC 1SP vs 2SP disambiguation (PROJ uses one name)
    if p["proj"] == "lcc" and "lat_1" not in p:
        p["proj"] = "lcc1sp"
        p.setdefault("lat_0", p.get("lat_0", 0.0))

    # Prime meridian
    if "pm" in raw:
        v = str(raw.pop("pm"))
        p["pm"] = _PRIME_MERIDIANS[v.lower()] if v.lower() in _PRIME_MERIDIANS else float(v)

    # Units
    if "units" in raw:
        u = str(raw.pop("units"))
        if u not in _UNITS_TO_M:
            raise NotImplementedError(f"+units={u} is not supported.")
        p["to_meter"] = _UNITS_TO_M[u]
    if "to_meter" in raw:
        p["to_meter"] = float(raw.pop("to_meter"))

    # Ignored / cosmetic keys
    for k in ("no_defs", "wktext", "type", "nadgrids", "geoidgrids", "over", "no_off",
              "axis", "vunits", "init"):
        raw.pop(k, None)
    if raw:
        _logger.debug("parse_projstring: ignoring unsupported keys %s", sorted(raw))
    return p

# --------------------------------------------------------------------------------------
# WKT parser (WKT1 "PROJCS[...]" / "GEOGCS[...]" and WKT2 "PROJCRS[...]" / "GEOGCRS[...]")
# --------------------------------------------------------------------------------------


class _WktNode:
    __slots__ = ("name", "items")

    def __init__(self, name: str):
        self.name = name
        self.items: list = []

    def children(self, name: str) -> list["_WktNode"]:
        name = name.upper()
        return [it for it in self.items if isinstance(it, _WktNode) and it.name == name]

    def child(self, *names: str) -> "_WktNode | None":
        for name in names:
            got = self.children(name)
            if got:
                return got[0]
        return None

    def find(self, *names: str) -> "_WktNode | None":
        """Depth-first search for the first node with one of the given names."""
        wanted = {n.upper() for n in names}
        stack: list[_WktNode] = [self]
        while stack:
            node = stack.pop(0)
            if node.name in wanted and node is not self:
                return node
            stack.extend(it for it in node.items if isinstance(it, _WktNode))
        return None

    def strings(self) -> list[str]:
        return [it for it in self.items if isinstance(it, str)]

    def numbers(self) -> list[float]:
        return [it for it in self.items if isinstance(it, float)]


def _tokenize_wkt(s: str):
    # Tokens: identifiers, quoted strings (doubled-quote escape), numbers, brackets, commas
    pattern = re.compile(
        r'\s*(?:("(?:[^"]|"")*")|([A-Za-z_][A-Za-z0-9_]*)|([-+]?[0-9][-+0-9.eE]*)|([\[\](),]))'
    )
    pos = 0
    while pos < len(s):
        m = pattern.match(s, pos)
        if not m:
            raise ValueError(f"WKT parse error at position {pos}: {s[pos:pos + 30]!r}")
        pos = m.end()
        if m.group(1) is not None:
            yield ("str", m.group(1)[1:-1].replace('""', '"'))
        elif m.group(2) is not None:
            yield ("ident", m.group(2))
        elif m.group(3) is not None:
            yield ("num", float(m.group(3)))
        else:
            yield ("punct", m.group(4))


def _parse_wkt_tree(s: str) -> _WktNode:
    tokens = list(_tokenize_wkt(s))
    pos = 0

    def parse_node() -> _WktNode:
        nonlocal pos
        kind, val = tokens[pos]
        if kind != "ident":
            raise ValueError(f"Expected WKT keyword, got {val!r}")
        node = _WktNode(str(val).upper())
        pos += 1
        if pos < len(tokens) and tokens[pos] == ("punct", "["):
            pos += 1
            while True:
                kind, val = tokens[pos]
                if kind == "ident":
                    node.items.append(parse_node())
                elif kind == "str":
                    node.items.append(val)
                    pos += 1
                elif kind == "num":
                    node.items.append(val)
                    pos += 1
                elif val == "(":  # some writers use parentheses
                    pos += 1
                    continue
                else:
                    raise ValueError(f"Unexpected WKT token {val!r}")
                kind, val = tokens[pos]
                if val == ",":
                    pos += 1
                    continue
                if val in ("]", ")"):
                    pos += 1
                    break
                raise ValueError(f"Expected ',' or ']' in WKT, got {val!r}")
        return node

    node = parse_node()
    return node


def looks_like_wkt(s: str) -> bool:
    head = s.lstrip()[:16].upper()
    return any(head.startswith(k) for k in (
        "PROJCS", "GEOGCS", "PROJCRS", "GEOGCRS", "COMPD_CS", "COMPOUNDCRS", "BOUNDCRS",
        "GEODCRS", "LOCAL_CS", "VERT_CS", "VERTCRS",
    ))


# WKT1 projection name -> internal proj key
_WKT1_PROJECTIONS = {
    "TRANSVERSE_MERCATOR": "tmerc",
    "GAUSS_KRUGER": "tmerc",
    "MERCATOR_1SP": "merc",
    "MERCATOR_2SP": "merc",
    "MERCATOR": "merc",
    "MERCATOR_AUXILIARY_SPHERE": "webmerc",
    "POPULAR_VISUALISATION_PSEUDO_MERCATOR": "webmerc",
    "PSEUDO_MERCATOR": "webmerc",
    "LAMBERT_CONFORMAL_CONIC_2SP": "lcc",
    "LAMBERT_CONFORMAL_CONIC_1SP": "lcc1sp",
    "LAMBERT_CONFORMAL_CONIC": "lcc",
    "ALBERS_CONIC_EQUAL_AREA": "aea",
    "ALBERS": "aea",
    "LAMBERT_AZIMUTHAL_EQUAL_AREA": "laea",
    "POLAR_STEREOGRAPHIC": "stere",
    "STEREOGRAPHIC_NORTH_POLE": "stere",
    "STEREOGRAPHIC_SOUTH_POLE": "stere",
    "OBLIQUE_STEREOGRAPHIC": "sterea",
    "DOUBLE_STEREOGRAPHIC": "sterea",
    "STEREOGRAPHIC": "sterea",
    "SWISS_OBLIQUE_CYLINDRICAL": "somerc",
    "SWISS_OBLIQUE_MERCATOR": "somerc",
    "HOTINE_OBLIQUE_MERCATOR_AZIMUTH_CENTER": "omerc",  # -> somerc below when azimuth == 90
    "HOTINE_OBLIQUE_MERCATOR": "omerc",
    "KROVAK": "krovak",
    "CYLINDRICAL_EQUAL_AREA": "cea",
    "EQUIRECTANGULAR": "eqc",
    "EQUIDISTANT_CYLINDRICAL": "eqc",
    "PLATE_CARREE": "eqc",
}

# EPSG method code -> internal proj key (WKT2 METHOD[..., ID["EPSG", code]])
_EPSG_METHODS = {
    9807: "tmerc", 9804: "merc", 9805: "merc", 1024: "webmerc",
    9801: "lcc1sp", 9802: "lcc", 9822: "aea", 9820: "laea",
    9810: "stere", 9829: "stere", 9809: "sterea", 9815: "omerc", 9812: "omerc",
    9819: "krovak",
    9835: "cea", 1028: "eqc", 1029: "eqc",
}

# WKT2 method names (upper, spaces removed) -> proj key
_WKT2_METHODS = {
    "TRANSVERSEMERCATOR": "tmerc",
    "MERCATOR(VARIANTA)": "merc",
    "MERCATOR(VARIANTB)": "merc",
    "POPULARVISUALISATIONPSEUDOMERCATOR": "webmerc",
    "LAMBERTCONICCONFORMAL(1SP)": "lcc1sp",
    "LAMBERTCONICCONFORMAL(2SP)": "lcc",
    "ALBERSEQUALAREA": "aea",
    "LAMBERTAZIMUTHALEQUALAREA": "laea",
    "POLARSTEREOGRAPHIC(VARIANTA)": "stere",
    "POLARSTEREOGRAPHIC(VARIANTB)": "stere",
    "OBLIQUESTEREOGRAPHIC": "sterea",
    "HOTINEOBLIQUEMERCATOR(VARIANTA)": "omerc",
    "HOTINEOBLIQUEMERCATOR(VARIANTB)": "omerc",
    "KROVAK": "krovak",
    "LAMBERTCYLINDRICALEQUALAREA": "cea",
    "EQUIDISTANTCYLINDRICAL": "eqc",
    "EQUIDISTANTCYLINDRICAL(SPHERICAL)": "eqc",
}

# Parameter name (upper, non-alnum stripped) -> internal key. Covers WKT1 + WKT2/EPSG names.
_WKT_PARAMS = {
    "LATITUDEOFORIGIN": "lat_0",
    "LATITUDEOFNATURALORIGIN": "lat_0",
    "LATITUDEOFFALSEORIGIN": "lat_0",
    "LATITUDEOFCENTER": "lat_0",
    "LATITUDEOFCENTRE": "lat_0",
    "LATITUDEOFPROJECTIONCENTRE": "lat_0",
    "CENTRALMERIDIAN": "lon_0",
    "LONGITUDEOFNATURALORIGIN": "lon_0",
    "LONGITUDEOFFALSEORIGIN": "lon_0",
    "LONGITUDEOFCENTER": "lon_0",
    "LONGITUDEOFCENTRE": "lon_0",
    "LONGITUDEOFPROJECTIONCENTRE": "lon_0",
    "LONGITUDEOFORIGIN": "lon_0",
    "STANDARDPARALLEL1": "lat_1",
    "LATITUDEOF1STSTANDARDPARALLEL": "lat_1",
    "STANDARDPARALLEL2": "lat_2",
    "LATITUDEOF2NDSTANDARDPARALLEL": "lat_2",
    "LATITUDEOFSTANDARDPARALLEL": "lat_ts",
    "SCALEFACTOR": "k_0",
    "SCALEFACTORATNATURALORIGIN": "k_0",
    "SCALEFACTORONINITIALLINE": "k_0",
    "FALSEEASTING": "x_0",
    "EASTINGATFALSEORIGIN": "x_0",
    "EASTINGATPROJECTIONCENTRE": "x_0",
    "FALSENORTHING": "y_0",
    "NORTHINGATFALSEORIGIN": "y_0",
    "NORTHINGATPROJECTIONCENTRE": "y_0",
    "AZIMUTH": "alpha",
    "AZIMUTHOFINITIALLINE": "alpha",
    "AZIMUTHATPROJECTIONCENTRE": "alpha",
    "RECTIFIEDGRIDANGLE": "gamma",
    "ANGLEFROMRECTIFIEDTOSKEWGRID": "gamma",
    "PSEUDOSTANDARDPARALLEL1": "lat_1",
    "LATITUDEOFPSEUDOSTANDARDPARALLEL": "lat_1",
    "COLATITUDEOFCONEAXIS": "alpha",
    "SCALEFACTORONPSEUDOSTANDARDPARALLEL": "k_0",
}

_ANGULAR_PARAMS = {"lat_0", "lon_0", "lat_1", "lat_2", "lat_ts", "alpha", "gamma"}
_LINEAR_PARAMS = {"x_0", "y_0"}

# Datum names (upper, non-alnum stripped) -> internal datum key, for WKT without TOWGS84
_WKT_DATUM_NAMES = {
    "OSGB1936": "OSGB36", "OSGB36": "OSGB36", "ORDNANCESURVEYOFGREATBRITAIN1936": "OSGB36",
    "NORTHAMERICANDATUM1927": "NAD27", "NAD27": "NAD27", "DNORTHAMERICAN1927": "NAD27",
    "EUROPEANDATUM1950": "ED50", "ED50": "ED50",
    "NOUVELLETRIANGULATIONFRANCAISE": "NTF", "NTF": "NTF",
    "NOUVELLETRIANGULATIONFRANCAISEPARIS": "NTF",
    "DEUTSCHESHAUPTDREIECKSNETZ": "DHDN", "DHDN": "DHDN", "POTSDAM": "DHDN",
    "AMERSFOORT": "Amersfoort",
    "CH1903": "CH1903", "CH1903PLUS": "CH1903+",
    "WGS1972": "WGS72", "WGS72": "WGS72", "WORLDGEODETICSYSTEM1972": "WGS72",
    "TM75": "TM75", "TM65": "TM75", "GEODETICDATUMOF1965": "TM75",
    "NEWZEALANDGEODETICDATUM1949": "NZGD49", "NZGD49": "NZGD49",
    "SOUTHAMERICANDATUM1969": "SAD69", "SAD69": "SAD69",
    "PULKOVO194258": "S42RO", "DEALULPISCULUI1970": "S42RO",
}


def _squash(name: str) -> str:
    return re.sub(r"[^A-Z0-9]", "", name.upper().replace("+", "PLUS"))


def _unit_factor(node: "_WktNode | None", default: float) -> float:
    """Conversion factor from a UNIT/ANGLEUNIT/LENGTHUNIT node (2nd value)."""
    if node is None:
        return default
    nums = node.numbers()
    return nums[0] if nums else default


def _epsg_id_of(node: _WktNode) -> int | None:
    for id_node in node.children("AUTHORITY") + node.children("ID"):
        vals = id_node.strings() + [str(int(n)) for n in id_node.numbers()]
        if vals and vals[0].upper() == "EPSG" and len(vals) > 1:
            try:
                return int(vals[1])
            except ValueError:
                return None
    return None


def parse_wkt(s: str) -> tuple[dict | None, int | None, str]:
    """Parse WKT1/WKT2 into (projdef-or-None, epsg-or-None, name).

    The projdef is un-normalized (pass through normalize_def). Returns (None, epsg, name)
    when only identification could be extracted (e.g. our own minimal identification WKT).
    """
    root = _parse_wkt_tree(s)
    if root.name in ("COMPD_CS", "COMPOUNDCRS", "BOUNDCRS"):
        for it in root.items:
            if isinstance(it, _WktNode) and it.name in ("PROJCS", "GEOGCS", "PROJCRS",
                                                        "GEOGCRS", "GEODCRS", "SOURCECRS"):
                root = it.items[0] if root.name == "BOUNDCRS" and isinstance(it.items[0], _WktNode) else it
                break
    name = (root.strings() or [""])[0]
    epsg = _epsg_id_of(root)

    # ---- geographic-only CRS ----
    if root.name in ("GEOGCS", "GEOGCRS", "GEODCRS"):
        p = _parse_wkt_geog(root)
        return p, epsg, name

    if root.name != "PROJCS" and root.name != "PROJCRS":
        return None, epsg, name

    # ---- base geographic CRS ----
    geog = root.child("GEOGCS", "BASEGEOGCRS", "BASEGEODCRS")
    base = _parse_wkt_geog(geog) if geog is not None else {"ellps": "WGS84"}
    geog_unit_deg = base.pop("_unit_deg", 1.0)
    pm = base.pop("pm", 0.0)

    # ---- projection method ----
    proj_key: str | None = None
    conv = root.child("CONVERSION")
    scope = conv if conv is not None else root
    method = scope.child("PROJECTION", "METHOD")
    if method is None and conv is not None:
        method = conv.child("PROJECTION", "METHOD")
    if method is None:
        # Identification-only PROJCS (e.g. our own minimal carried-code WKT): return the
        # EPSG/name so the caller can round-trip it; no parameters to build a def from
        return None, epsg, name
    mcode = _epsg_id_of(method)
    mname = (method.strings() or [""])[0]
    if mcode in _EPSG_METHODS:
        proj_key = _EPSG_METHODS[mcode]
    else:
        squashed = _squash(mname)
        proj_key = _WKT2_METHODS.get(squashed) or _WKT1_PROJECTIONS.get(
            re.sub(r"[^A-Z0-9_]", "_", mname.upper().replace(" ", "_"))
        ) or _WKT1_PROJECTIONS.get(squashed)
    if proj_key is None:
        raise NotImplementedError(f"WKT projection method {mname!r} is not supported.")

    p: dict[str, Any] = {**{k: v for k, v in base.items() if k not in ("name", "proj")},
                         "proj": proj_key}

    # ---- linear unit of the projected CS ----
    unit = root.child("UNIT", "LENGTHUNIT")
    if unit is None:
        cs = root.child("CS")
        axes = root.children("AXIS")
        for ax in axes:
            u = ax.child("LENGTHUNIT", "UNIT")
            if u is not None:
                unit = u
                break
        del cs
    to_meter = _unit_factor(unit, 1.0)

    # ---- parameters ----
    params = scope.children("PARAMETER")
    if not params:
        params = root.children("PARAMETER")
    for par in params:
        pname = (par.strings() or [""])[0]
        key = _WKT_PARAMS.get(_squash(pname))
        if key is None:
            _logger.debug("parse_wkt: ignoring parameter %r", pname)
            continue
        nums = par.numbers()
        if not nums:
            continue
        val = nums[0]
        if key in _ANGULAR_PARAMS:
            au = par.child("ANGLEUNIT", "UNIT")
            if au is not None:
                val = val * _unit_factor(au, math.pi / 180.0) * 180.0 / math.pi
            else:
                val = val * geog_unit_deg
        elif key in _LINEAR_PARAMS:
            lu = par.child("LENGTHUNIT", "UNIT")
            val = val * (_unit_factor(lu, to_meter))
        p[key] = val

    if to_meter != 1.0:
        p["to_meter"] = to_meter
    if pm:
        p["pm"] = pm

    # ---- per-family fixups ----
    mname_u = re.sub(r"[^A-Z0-9_]", "_", mname.upper().replace(" ", "_"))
    if proj_key == "stere":
        # WKT1 Polar_Stereographic stores lat_ts in latitude_of_origin (variant B);
        # ESRI North/South Pole variants use standard_parallel_1.
        if mname_u in ("STEREOGRAPHIC_NORTH_POLE", "STEREOGRAPHIC_SOUTH_POLE"):
            p["lat_ts"] = p.pop("lat_1", p.get("lat_ts", p.get("lat_0", 90.0)))
            p["lat_0"] = 90.0 if "NORTH" in mname_u else -90.0
        elif mcode == 9829 or (mcode is None and abs(abs(p.get("lat_0", 90.0)) - 90.0) > 1e-9):
            lat_ts = p.get("lat_ts", p.get("lat_0", 90.0))
            if "lat_ts" not in p:
                p["lat_ts"] = lat_ts
            p["lat_0"] = 90.0 if lat_ts >= 0 else -90.0
    if proj_key == "merc" and "lat_1" in p:
        p["lat_ts"] = p.pop("lat_1")
    if proj_key in ("cea", "eqc") and "lat_1" in p:
        p["lat_ts"] = p.pop("lat_1")
    if proj_key == "lcc" and "lat_2" not in p and "lat_1" not in p:
        p["proj"] = "lcc1sp"
    if proj_key == "somerc":
        p.pop("alpha", None)
        p.pop("gamma", None)
    if proj_key == "omerc":
        alpha = p.get("alpha", 90.0)
        gamma = p.get("gamma", alpha)
        if abs(alpha - 90.0) < 1e-9 and abs(gamma - 90.0) < 1e-9:
            # Azimuth-90 special case == Swiss oblique Mercator
            p["proj"] = "somerc"
            p.pop("alpha", None)
            p.pop("gamma", None)
    return p, epsg, name


def _parse_wkt_geog(node: _WktNode) -> dict:
    """Extract ellipsoid/datum/prime-meridian from a GEOGCS/GEOGCRS node."""
    p: dict[str, Any] = {}
    datum = node.child("DATUM", "TRF", "GEODETICDATUM")
    if datum is not None:
        dname = (datum.strings() or [""])[0]
        sph = datum.child("SPHEROID", "ELLIPSOID")
        if sph is not None:
            nums = sph.numbers()
            if len(nums) >= 2:
                a, rf = nums[0], nums[1]
                p["a"] = a
                p["f"] = (1.0 / rf) if rf != 0 else 0.0
        tow = datum.child("TOWGS84")
        if tow is not None:
            p["towgs84"] = tuple(tow.numbers())
        else:
            dkey = _WKT_DATUM_NAMES.get(_squash(dname))
            if dkey:
                p["datum"] = dkey
    if "a" not in p and "ellps" not in p:
        p["ellps"] = "WGS84"
    primem = node.child("PRIMEM")
    unit = node.child("UNIT", "ANGLEUNIT")
    unit_rad = _unit_factor(unit, math.pi / 180.0)
    unit_deg = unit_rad * 180.0 / math.pi
    p["_unit_deg"] = unit_deg
    if primem is not None:
        nums = primem.numbers()
        if nums and nums[0] != 0.0:
            # WKT2 PRIMEM may carry its own ANGLEUNIT (e.g. Paris in grads); the GEOGCS
            # unit applies only when no per-node unit is given
            pm_unit = primem.child("ANGLEUNIT", "UNIT")
            pm_deg = (_unit_factor(pm_unit, unit_rad) * 180.0 / math.pi
                      if pm_unit is not None else unit_deg)
            p["pm"] = nums[0] * pm_deg
    p["proj"] = "longlat"
    return p


# --------------------------------------------------------------------------------------
# WKT1 writer (round-trippable through GeoTIFF citation keys; readable by GDAL)
# --------------------------------------------------------------------------------------


def _ellps_wkt_name(a: float, f: float) -> str:
    for name, (ea, ef) in ELLIPSOIDS.items():
        if abs(ea - a) < 1e-6 and abs(ef - f) < 1e-12:
            return {"WGS84": "WGS 84", "GRS80": "GRS 1980", "intl": "International 1924",
                    "clrk66": "Clarke 1866", "clrk80ign": "Clarke 1880 (IGN)",
                    "airy": "Airy 1830", "mod_airy": "Airy Modified 1849",
                    "bessel": "Bessel 1841", "krass": "Krassowsky 1940",
                    "WGS72": "WGS 72", "GRS67": "GRS 1967", "aust_SA": "Australian National",
                    "hughes": "Hughes 1980", "sphere": "Sphere"}.get(name, name)
    return "unnamed"


_WKT1_PROJ_NAMES = {
    "tmerc": "Transverse_Mercator",
    "merc": "Mercator_1SP",          # switched to 2SP below when lat_ts present
    "webmerc": "Popular_Visualisation_Pseudo_Mercator",
    "lcc": "Lambert_Conformal_Conic_2SP",
    "lcc1sp": "Lambert_Conformal_Conic_1SP",
    "aea": "Albers_Conic_Equal_Area",
    "laea": "Lambert_Azimuthal_Equal_Area",
    "stere": "Polar_Stereographic",
    "sterea": "Oblique_Stereographic",
    "somerc": "Hotine_Oblique_Mercator_Azimuth_Center",
    "omerc": "Hotine_Oblique_Mercator_Azimuth_Center",
    "krovak": "Krovak",
    "cea": "Cylindrical_Equal_Area",
    "eqc": "Equirectangular",
}


def def_to_wkt1(p: dict, name: str = "", epsg: int | None = None) -> str:
    """Write a normalized projdef as WKT1 (GDAL style, parameters in degrees/meters)."""
    a, f = p["a"], p["f"]
    rf = (1.0 / f) if f else 0.0
    ename = _ellps_wkt_name(a, f)
    tow = p.get("towgs84")
    tow_s = f",TOWGS84[{','.join(_fmt(v) for v in tow)}]" if tow else ""
    datum_name = p.get("datum", "unknown")
    geog_name = p.get("geog_name", "unknown")
    geogcs = (
        f'GEOGCS["{geog_name}",DATUM["{datum_name}",'
        f'SPHEROID["{ename}",{_fmt(a)},{_fmt(rf)}]{tow_s}],'
        f'PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]]'
    )
    if p["proj"] == "longlat":
        body = geogcs
        if epsg:
            body = body[:-1] + f',AUTHORITY["EPSG","{epsg}"]]'
        return body.replace('GEOGCS["unknown"', f'GEOGCS["{name or "unknown"}"', 1)

    proj_name = _WKT1_PROJ_NAMES[p["proj"]]
    pars: list[tuple[str, float]] = []
    if p["proj"] == "webmerc":
        # NOT Mercator_1SP: the spherical pseudo-Mercator differs from ellipsoidal
        # Mercator by up to ~20 km in northing; use the EPSG method name
        pars = [("central_meridian", p.get("lon_0", 0.0)),
                ("false_easting", p.get("x_0", 0.0)), ("false_northing", p.get("y_0", 0.0))]
    elif p["proj"] == "merc":
        if "lat_ts" in p:
            proj_name = "Mercator_2SP"
            pars.append(("standard_parallel_1", p["lat_ts"]))
        else:
            pars.append(("scale_factor", p.get("k_0", 1.0)))
        pars += [("central_meridian", p.get("lon_0", 0.0)),
                 ("false_easting", p.get("x_0", 0.0)), ("false_northing", p.get("y_0", 0.0))]
    elif p["proj"] == "stere":
        lat_ts = p.get("lat_ts", p.get("lat_0", 90.0))
        pars = [("latitude_of_origin", lat_ts if "lat_ts" in p else p.get("lat_0", 90.0)),
                ("central_meridian", p.get("lon_0", 0.0))]
        if "lat_ts" not in p:  # variant A: scale at the pole
            pars.append(("scale_factor", p.get("k_0", 1.0)))
        pars += [("false_easting", p.get("x_0", 0.0)), ("false_northing", p.get("y_0", 0.0))]
    elif p["proj"] in ("somerc", "omerc"):
        az = p.get("alpha", 90.0) if p["proj"] == "omerc" else 90.0
        ga = p.get("gamma", az) if p["proj"] == "omerc" else 90.0
        pars = [("latitude_of_center", p.get("lat_0", 0.0)),
                ("longitude_of_center", p.get("lon_0", 0.0)),
                ("azimuth", az), ("rectified_grid_angle", ga),
                ("scale_factor", p.get("k_0", 1.0)),
                ("false_easting", p.get("x_0", 0.0)), ("false_northing", p.get("y_0", 0.0))]
    elif p["proj"] == "krovak":
        pars = [("latitude_of_center", p.get("lat_0", 0.0)),
                ("longitude_of_center", p.get("lon_0", 0.0)),
                ("azimuth", p.get("alpha", 30.28813972222222)),
                ("pseudo_standard_parallel_1", p.get("lat_1", 78.5)),
                ("scale_factor", p.get("k_0", 0.9999)),
                ("false_easting", p.get("x_0", 0.0)), ("false_northing", p.get("y_0", 0.0))]
    else:
        if "lat_ts" in p:
            pars.append(("standard_parallel_1", p["lat_ts"]))
        if "lat_1" in p:
            pars.append(("standard_parallel_1", p["lat_1"]))
        if "lat_2" in p:
            pars.append(("standard_parallel_2", p["lat_2"]))
        key = "latitude_of_center" if p["proj"] in ("laea", "aea") else "latitude_of_origin"
        pars.append((key, p.get("lat_0", 0.0)))
        key = "longitude_of_center" if p["proj"] in ("laea", "aea") else "central_meridian"
        pars.append((key, p.get("lon_0", 0.0)))
        if "k_0" in p and p["proj"] in ("tmerc", "lcc1sp", "sterea"):
            pars.append(("scale_factor", p["k_0"]))
        pars += [("false_easting", p.get("x_0", 0.0)), ("false_northing", p.get("y_0", 0.0))]

    to_meter = p.get("to_meter", 1.0)
    # x_0/y_0 are stored in meters; express them in the CS unit in WKT
    pars = [(k, v / to_meter) if k in ("false_easting", "false_northing") else (k, v)
            for k, v in pars]
    par_s = ",".join(f'PARAMETER["{k}",{_fmt(v)}]' for k, v in pars)
    unit_s = 'UNIT["metre",1]' if to_meter == 1.0 else f'UNIT["unknown",{_fmt(to_meter)}]'
    auth = f',AUTHORITY["EPSG","{epsg}"]' if epsg else ""
    return (f'PROJCS["{name or "unknown"}",{geogcs},PROJECTION["{proj_name}"],'
            f"{par_s},{unit_s}{auth}]")


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(round(v, 13))

# --------------------------------------------------------------------------------------
# Krovak (EPSG method 9819) — S-JTSK, Czech Republic / Slovakia
# --------------------------------------------------------------------------------------


def _krovak_consts(p: dict) -> dict:
    ell = _ell_consts(p)
    a, e, e2 = ell["a"], ell["e"], ell["e2"]
    phic = math.radians(p["lat_0"])            # latitude of projection centre (49.5)
    alphac = math.radians(p.get("alpha", 30.28813972222222))  # cone-axis azimuth
    phip = math.radians(p.get("lat_1", 78.5))  # pseudo standard parallel
    kp = p.get("k_0", 0.9999)
    sc = math.sin(phic)
    A = a * math.sqrt(1 - e2) / (1 - e2 * sc * sc)
    B = math.sqrt(1 + e2 * math.cos(phic) ** 4 / (1 - e2))
    gamma0 = math.asin(sc / B)
    t0 = (
        math.tan(math.pi / 4 + gamma0 / 2)
        * ((1 + e * sc) / (1 - e * sc)) ** (e * B / 2)
        / math.tan(math.pi / 4 + phic / 2) ** B
    )
    n = math.sin(phip)
    r0 = kp * A / math.tan(phip)
    return {**ell, "A": A, "B": B, "gamma0": gamma0, "t0": t0, "n": n, "r0": r0,
            "alphac": alphac, "phip": phip}


def krovak_forward(lon, lat, p: dict, xp: Any = np):
    """Krovak forward. Returns the (negative) East/North axes of EPSG:5514:
    E = -Westing, N = -Southing."""
    c = _krovak_consts(p)
    e, B = c["e"], c["B"]
    phi = xp.deg2rad(lat)
    u_big = 2 * (
        xp.arctan(
            c["t0"] * xp.tan(phi / 2 + xp.pi / 4) ** B
            / ((1 + e * xp.sin(phi)) / (1 - e * xp.sin(phi))) ** (e * B / 2)
        )
        - xp.pi / 4
    )
    v_big = B * xp.deg2rad(p["lon_0"] - lon)
    t_big = xp.arcsin(
        xp.clip(math.cos(c["alphac"]) * xp.sin(u_big)
                + math.sin(c["alphac"]) * xp.cos(u_big) * xp.cos(v_big), -1.0, 1.0)
    )
    d_big = xp.arcsin(xp.clip(xp.cos(u_big) * xp.sin(v_big) / xp.cos(t_big), -1.0, 1.0))
    theta = c["n"] * d_big
    r = c["r0"] * math.tan(math.pi / 4 + c["phip"] / 2) ** c["n"] \
        / xp.tan(t_big / 2 + xp.pi / 4) ** c["n"]
    southing = r * xp.cos(theta)
    westing = r * xp.sin(theta)
    x = -westing + p.get("x_0", 0.0)
    y = -southing + p.get("y_0", 0.0)
    return x, y


def krovak_inverse(x, y, p: dict, xp: Any = np):
    c = _krovak_consts(p)
    e, B = c["e"], c["B"]
    westing = -(x - p.get("x_0", 0.0))
    southing = -(y - p.get("y_0", 0.0))
    r = xp.sqrt(westing**2 + southing**2)
    theta = xp.arctan2(westing, southing)
    d_big = theta / c["n"]
    t_big = 2 * (
        xp.arctan((c["r0"] / r) ** (1.0 / c["n"]) * math.tan(math.pi / 4 + c["phip"] / 2))
        - xp.pi / 4
    )
    u_big = xp.arcsin(xp.clip(math.cos(c["alphac"]) * xp.sin(t_big)
                              - math.sin(c["alphac"]) * xp.cos(t_big) * xp.cos(d_big), -1.0, 1.0))
    v_big = xp.arcsin(xp.clip(xp.cos(t_big) * xp.sin(d_big) / xp.cos(u_big), -1.0, 1.0))
    lon = p["lon_0"] - xp.rad2deg(v_big / B)
    # Iterate geodetic latitude from the conformal-sphere latitude U
    phi = u_big
    for _ in range(6):
        phi = 2 * (
            xp.arctan(
                c["t0"] ** (-1.0 / B)
                * xp.tan(u_big / 2 + xp.pi / 4) ** (1.0 / B)
                * ((1 + e * xp.sin(phi)) / (1 - e * xp.sin(phi))) ** (e / 2)
            )
            - xp.pi / 4
        )
    return lon, xp.rad2deg(phi)


_FORWARD["krovak"] = krovak_forward
_INVERSE["krovak"] = krovak_inverse
_PROJ_ALIASES["krovak"] = "krovak"

_EPSG_DEFS[5514] = dict(
    proj="krovak", lat_0=49.5, lon_0=24.833333333333332, alpha=30.28813972222222,
    lat_1=78.5, k_0=0.9999, x_0=0.0, y_0=0.0, ellps="bessel",
    towgs84=(589.0, 76.0, 480.0), name="S-JTSK / Krovak East North",
)
_EPSG_DEFS[2065] = dict(
    proj="krovak", lat_0=49.5, lon_0=24.833333333333332, alpha=30.28813972222222,
    lat_1=78.5, k_0=0.9999, x_0=0.0, y_0=0.0, ellps="bessel",
    towgs84=(589.0, 76.0, 480.0), name="S-JTSK (Ferro) / Krovak",
)

# --------------------------------------------------------------------------------------
# Hotine oblique Mercator, variant B / azimuth-center (EPSG method 9815, general azimuth)
# --------------------------------------------------------------------------------------


def _omerc_consts(p: dict) -> dict:
    ell = _ell_consts(p)
    a, e, e2 = ell["a"], ell["e"], ell["e2"]
    phic = math.radians(p["lat_0"])
    alphac = math.radians(p["alpha"])
    gammac = math.radians(p.get("gamma", p["alpha"]))
    kc = p.get("k_0", 1.0)
    sc = math.sin(phic)
    B = math.sqrt(1 + e2 * math.cos(phic) ** 4 / (1 - e2))
    A = a * B * kc * math.sqrt(1 - e2) / (1 - e2 * sc * sc)
    t0 = math.tan(math.pi / 4 - phic / 2) / ((1 - e * sc) / (1 + e * sc)) ** (e / 2)
    D = B * math.sqrt(1 - e2) / (math.cos(phic) * math.sqrt(1 - e2 * sc * sc))
    D2 = max(D * D, 1.0)
    F = D + math.copysign(math.sqrt(D2 - 1.0), phic)
    H = F * t0**B
    G = (F - 1.0 / F) / 2.0
    gamma0 = math.asin(math.sin(alphac) / D)
    lam0 = math.radians(p["lon_0"]) - math.asin(G * math.tan(gamma0)) / B
    uc = (A / B) * math.atan2(math.sqrt(D2 - 1.0), math.cos(alphac)) * math.copysign(1.0, phic)
    return {**ell, "A": A, "B": B, "H": H, "gamma0": gamma0, "gammac": gammac,
            "lam0": lam0, "uc": uc}


def omerc_forward(lon, lat, p: dict, xp: Any = np):
    c = _omerc_consts(p)
    e, A, B, H = c["e"], c["A"], c["B"], c["H"]
    phi = xp.deg2rad(lat)
    lam = xp.deg2rad(lon)
    t = _t_snyder(phi, e, xp)
    q_big = H / t**B
    s_big = (q_big - 1.0 / q_big) / 2.0
    t_big = (q_big + 1.0 / q_big) / 2.0
    v_big = xp.sin(B * (lam - c["lam0"]))
    u_big = (-v_big * math.cos(c["gamma0"]) + s_big * math.sin(c["gamma0"])) / t_big
    v = A * xp.log((1 - u_big) / (1 + u_big)) / (2 * B)
    u = A * xp.arctan2(s_big * math.cos(c["gamma0"]) + v_big * math.sin(c["gamma0"]),
                       xp.cos(B * (lam - c["lam0"]))) / B
    u = u - c["uc"]  # variant B: u measured from the projection centre
    x = v * math.cos(c["gammac"]) + u * math.sin(c["gammac"]) + p.get("x_0", 0.0)
    y = u * math.cos(c["gammac"]) - v * math.sin(c["gammac"]) + p.get("y_0", 0.0)
    return x, y


def omerc_inverse(x, y, p: dict, xp: Any = np):
    c = _omerc_consts(p)
    e, A, B, H = c["e"], c["A"], c["B"], c["H"]
    dx = x - p.get("x_0", 0.0)
    dy = y - p.get("y_0", 0.0)
    v = dx * math.cos(c["gammac"]) - dy * math.sin(c["gammac"])
    u = dy * math.cos(c["gammac"]) + dx * math.sin(c["gammac"]) + c["uc"]
    q_big = xp.exp(-B * v / A)
    s_big = (q_big - 1.0 / q_big) / 2.0
    t_big = (q_big + 1.0 / q_big) / 2.0
    v_big = xp.sin(B * u / A)
    u_big = (v_big * math.cos(c["gamma0"]) + s_big * math.sin(c["gamma0"])) / t_big
    t = (H / xp.sqrt((1 + u_big) / (1 - u_big))) ** (1.0 / B)
    phi = _lat_from_t(t, e, xp)
    lam = c["lam0"] - xp.arctan2(s_big * math.cos(c["gamma0"]) - v_big * math.sin(c["gamma0"]),
                                 xp.cos(B * u / A)) / B
    return xp.rad2deg(lam), xp.rad2deg(phi)


_FORWARD["omerc"] = omerc_forward
_INVERSE["omerc"] = omerc_inverse
_PROJ_ALIASES["omerc"] = "omerc"

ELLIPSOIDS.setdefault("evrst30", (6377276.345, 1.0 / 300.8017))
ELLIPSOIDS.setdefault("evrstSS", (6377298.556, 1.0 / 300.8017))  # Everest 1830 (Sabah/Sarawak)

_EPSG_DEFS[29873] = dict(  # Timbalai 1948 / RSO Borneo (m)
    proj="omerc", lat_0=4.0, lon_0=115.0, alpha=53.31582466111111, gamma=53.13010236111111,
    k_0=0.99984, x_0=590476.87, y_0=442857.65, ellps="evrstSS",
    towgs84=(-679.0, 669.0, -48.0), name="Timbalai 1948 / RSO Borneo (m)",
)
_EPSG_DEFS[3376] = dict(  # GDM2000 / East Malaysia BRSO
    proj="omerc", lat_0=4.0, lon_0=115.0, alpha=53.31580995, gamma=53.13010236111111,
    k_0=0.99984, x_0=0.0, y_0=0.0, ellps="GRS80", name="GDM2000 / East Malaysia BRSO",
)


# --------------------------------------------------------------------------------------
# GeoTIFF GeoKeys <-> projdef (user-defined projected CRSs in GeoTIFF files)
# --------------------------------------------------------------------------------------
# GDAL writes custom (non-EPSG) CRSs into GeoTIFFs as parameter GeoKeys: ProjCoordTransGeoKey
# (3075, the coordinate-transformation method code from GeoTIFF spec 6.3.3.3) plus
# ProjNatOrigin*/ProjFalse*/ProjCenter*/ProjScale* double keys (3078-3096), with the
# geographic base carried as GeographicTypeGeoKey (2048) or raw ellipsoid parameters
# (2056-2059) and GeogTOWGS84GeoKey (2062). The reference ingests these through
# rasterio/pyproj (upstream xdem's dem.py); here they map directly onto the
# projdef kernels above.

# GeoTIFF CT codes -> projdef method. CT_Stereographic (14) is what GDAL resolves to
# +proj=stere (Snyder oblique stereographic); our 'stere' kernel is polar-only, so
# projdef_from_geokeys special-cases 14: a polar origin reads as 'stere' (GDAL parity),
# an oblique origin falls back to the double stereographic 'sterea' (EPSG 9809) with a
# UserWarning — the two projections deviate at meter scale far from the origin.
# CT_ObliqueMercator_Rosenmund (5) is the Swiss oblique cylindrical.
_CT_TO_PROJ = {
    1: "tmerc", 3: "omerc", 5: "somerc", 7: "merc", 8: "lcc", 9: "lcc1sp",
    10: "laea", 11: "aea", 14: "sterea", 15: "stere", 16: "sterea", 17: "eqc", 28: "cea",
}
_PROJ_TO_CT = {
    "tmerc": 1, "omerc": 3, "somerc": 5, "merc": 7, "lcc": 8, "lcc1sp": 9,
    "laea": 10, "aea": 11, "stere": 15, "sterea": 16, "eqc": 17, "cea": 28,
}

# GeogEllipsoidGeoKey (2056) EPSG ellipsoid codes <-> projdef ellipsoid names
_ELLIPSOID_CODES = {
    7030: "WGS84", 7019: "GRS80", 7022: "intl", 7008: "clrk66", 7011: "clrk80ign",
    7001: "airy", 7002: "mod_airy", 7004: "bessel", 7024: "krass", 7043: "WGS72",
    7036: "GRS67", 7003: "aust_SA", 7058: "hughes",
}
_ELLIPSOID_NAMES_TO_CODE = {v: k for k, v in _ELLIPSOID_CODES.items()}

# ProjLinearUnitsGeoKey (3076) EPSG unit codes
_LINEAR_UNITS = {9001: 1.0, 9002: 0.3048, 9003: 1200.0 / 3937.0}


def _gk(keys: dict, *ids: int, default=None):
    """First present key among ids, as a float (double keys arrive as 1-tuples)."""
    for i in ids:
        if i in keys:
            v = keys[i]
            return float(v[0]) if isinstance(v, (tuple, list)) else float(v)
    return default


def projdef_from_geokeys(keys: dict) -> dict:
    """Build a normalized projdef from a GeoTIFF GeoKey directory (dict: key id -> int for
    SHORT keys, tuple of floats for DOUBLE keys). Raises ValueError/NotImplementedError when
    the keys do not describe a supported CRS — callers must not fall back silently."""
    # --- Geographic base: datum / ellipsoid
    base: dict = {}
    geog = keys.get(2048)
    geog = int(geog[0]) if isinstance(geog, (tuple, list)) else (int(geog) if geog else None)
    if geog and geog != 32767:
        bd = epsg_def(geog)
        if bd is None or bd.get("proj", "longlat") != "longlat":
            raise NotImplementedError(
                f"GeographicTypeGeoKey {geog} is not in the EPSG table "
                f"(georeference with ellipsoid GeoKeys 2056-2059 or a citation WKT instead)."
            )
        for k in ("ellps", "datum", "towgs84", "a", "f", "rf"):
            if k in bd:
                base[k] = bd[k]
    else:
        ell = keys.get(2056)
        ell = int(ell[0]) if isinstance(ell, (tuple, list)) else (int(ell) if ell else None)
        if ell and ell in _ELLIPSOID_CODES:
            base["ellps"] = _ELLIPSOID_CODES[ell]
        elif 2057 in keys:
            base["a"] = _gk(keys, 2057)
            rf = _gk(keys, 2059)
            if rf:
                base["rf"] = rf
            elif 2058 in keys:
                base["b"] = _gk(keys, 2058)
        # No geographic info at all: WGS84 (normalize_def's default)
    if 2062 in keys:  # GeogTOWGS84GeoKey: 3 or 7 Helmert parameters
        tw = keys[2062]
        base["towgs84"] = tuple(float(v) for v in (tw if isinstance(tw, (tuple, list)) else (tw,)))

    model = keys.get(1024)
    model = int(model[0]) if isinstance(model, (tuple, list)) else (int(model) if model else 0)
    if model == 2:  # geographic 2D
        return normalize_def(dict(proj="longlat", **base))

    # --- Projected: a direct PCS code wins, else the method + parameter keys
    pcs = keys.get(3072)
    pcs = int(pcs[0]) if isinstance(pcs, (tuple, list)) else (int(pcs) if pcs else None)
    if pcs and pcs != 32767:
        d = epsg_def(pcs)
        if d is None:
            raise NotImplementedError(f"ProjectedCSTypeGeoKey EPSG:{pcs} is not in the table.")
        return normalize_def(d)
    ct = keys.get(3075)
    ct = int(ct[0]) if isinstance(ct, (tuple, list)) else (int(ct) if ct else None)
    if ct is None:
        raise ValueError("GeoKeys carry no ProjCoordTransGeoKey (3075) and no EPSG code.")
    proj = _CT_TO_PROJ.get(ct)
    if proj is None:
        raise NotImplementedError(
            f"GeoTIFF coordinate transformation code {ct} is not supported "
            f"(supported methods: {', '.join(sorted(set(_CT_TO_PROJ.values())))})."
        )
    if ct == 14:
        # GDAL resolves CT_Stereographic (14) to +proj=stere. Polar origins hit the exact
        # polar 'stere' kernel (GDAL parity); oblique origins approximate with the double
        # stereographic 'sterea' and say so (meter-scale deviation far from the origin).
        nat_lat_14 = _gk(keys, 3081, 3085, 3089, default=90.0)
        if abs(abs(nat_lat_14) - 90.0) < 1e-9:
            proj = "stere"
        else:
            import warnings

            warnings.warn(
                "GeoTIFF CT_Stereographic (14) with an oblique origin is read as the double "
                "(oblique) stereographic 'sterea' (EPSG method 9809); GDAL's +proj=stere "
                "(Snyder) differs from it at meter scale far from the projection origin.",
                UserWarning,
            )

    p: dict = {"proj": proj, **base}
    # Origin/false-offset keys: natural-origin, false-origin, and center variants are all
    # accepted on read (GDAL emits different families per method)
    lat_0 = _gk(keys, 3081, 3085, 3089)
    lon_0 = _gk(keys, 3080, 3084, 3088)
    x_0 = _gk(keys, 3082, 3086, 3090, default=0.0)
    y_0 = _gk(keys, 3083, 3087, 3091, default=0.0)
    k_0 = _gk(keys, 3092, 3093)
    p["x_0"], p["y_0"] = x_0, y_0
    if proj in ("tmerc", "lcc1sp", "sterea", "somerc"):
        p["lat_0"], p["lon_0"] = lat_0 or 0.0, lon_0 or 0.0
        p["k_0"] = k_0 if k_0 is not None else 1.0
    elif proj == "merc":
        p["lon_0"] = lon_0 or 0.0
        lat_ts = _gk(keys, 3078)
        if lat_ts is not None:
            p["lat_ts"] = lat_ts
        elif k_0 is not None:
            p["k_0"] = k_0
    elif proj == "lcc":
        p["lat_1"] = _gk(keys, 3078)
        p["lat_2"] = _gk(keys, 3079, default=p["lat_1"])
        p["lat_0"], p["lon_0"] = lat_0 or 0.0, lon_0 or 0.0
        if p["lat_1"] is None:  # 1SP written with the 2SP CT code
            p["proj"] = "lcc1sp"
            p.pop("lat_1"), p.pop("lat_2")
            p["k_0"] = k_0 if k_0 is not None else 1.0
        elif k_0 is not None:  # 2SP defs can still carry a scale (e.g. Lambert zone grids)
            p["k_0"] = k_0
    elif proj == "aea":
        p["lat_1"] = _gk(keys, 3078)
        p["lat_2"] = _gk(keys, 3079, default=p["lat_1"])
        p["lat_0"], p["lon_0"] = lat_0 or 0.0, lon_0 or 0.0
    elif proj == "laea":
        p["lat_0"] = _gk(keys, 3089, 3081, default=0.0)
        p["lon_0"] = _gk(keys, 3088, 3080, default=0.0)
    elif proj == "stere":
        # GDAL's CT_PolarStereographic convention (variant B): the STANDARD PARALLEL is
        # written into ProjNatOriginLatGeoKey 3081 with lat_0=+-90 implied by its sign; a
        # +-90 in 3081 is variant A (scale in 3092). An explicit ProjStdParallel1 3078
        # (our own writer's legacy emission) still wins as lat_ts.
        nat_lat = _gk(keys, 3081, 3089, default=90.0)
        p["lon_0"] = _gk(keys, 3095, 3080, 3088, default=0.0)
        lat_ts = _gk(keys, 3078)
        if lat_ts is not None:
            p["lat_0"] = nat_lat
            p["lat_ts"] = lat_ts
        elif abs(nat_lat) != 90.0:
            p["lat_0"] = 90.0 if nat_lat >= 0.0 else -90.0
            p["lat_ts"] = nat_lat
        else:
            p["lat_0"] = nat_lat
            if k_0 is not None:
                p["k_0"] = k_0
    elif proj == "eqc":
        p["lat_ts"] = _gk(keys, 3078, default=0.0)
        p["lat_0"], p["lon_0"] = lat_0 or 0.0, lon_0 or 0.0
    elif proj == "cea":
        p["lat_ts"] = _gk(keys, 3078, default=0.0)
        p["lon_0"] = lon_0 or 0.0
    elif proj == "omerc":
        p["lat_0"] = _gk(keys, 3089, 3081, default=0.0)
        p["lon_0"] = _gk(keys, 3088, 3080, default=0.0)
        alpha = _gk(keys, 3094)
        if alpha is None:
            raise ValueError("Oblique Mercator GeoKeys need ProjAzimuthAngleGeoKey (3094).")
        p["alpha"] = alpha
        p["gamma"] = _gk(keys, 3096, default=alpha)  # ProjRectifiedGridAngleGeoKey
        p["k_0"] = _gk(keys, 3093, 3092, default=1.0)

    # Linear units: EPSG code or explicit unit size
    unit = keys.get(3076)
    unit = int(unit[0]) if isinstance(unit, (tuple, list)) else (int(unit) if unit else 9001)
    if unit == 32767:
        p["to_meter"] = _gk(keys, 3077, default=1.0)  # ProjLinearUnitSizeGeoKey
    elif unit in _LINEAR_UNITS:
        p["to_meter"] = _LINEAR_UNITS[unit]
    else:
        raise NotImplementedError(f"ProjLinearUnitsGeoKey {unit} is not supported.")
    return normalize_def(p)


def geokeys_from_projdef(d: dict) -> dict:
    """The writing inverse: GeoKeys (key id -> int SHORT or float/tuple DOUBLE) describing a
    projdef, so GDAL can read files with non-EPSG CRSs without trusting the citation WKT.
    Returns {} when the method has no GeoTIFF CT code (krovak, webmerc) — the citation WKT
    then carries the CRS alone."""
    p = normalize_def(d)
    out: dict = {}
    # Geographic base: exact WGS84 with no shift -> 4326; else user-defined + raw parameters
    a, f = p["a"], p["f"]
    wgs84 = ELLIPSOIDS["WGS84"]
    if (a, f) == wgs84 and not p.get("towgs84"):
        out[2048] = 4326
    else:
        out[2048] = 32767
        for name, (ea, ef) in ELLIPSOIDS.items():
            if abs(ea - a) < 1e-6 and abs(ef - f) < 1e-12 and name in _ELLIPSOID_NAMES_TO_CODE:
                out[2056] = _ELLIPSOID_NAMES_TO_CODE[name]
                break
        out[2057] = float(a)  # GeogSemiMajorAxisGeoKey (always written: self-contained)
        if f:
            out[2059] = 1.0 / f  # GeogInvFlatteningGeoKey
        if p.get("towgs84"):
            out[2062] = tuple(float(v) for v in p["towgs84"])
    if p["proj"] == "longlat":
        return out
    ct = _PROJ_TO_CT.get(p["proj"])
    if ct is None:
        return {}
    out[3074] = 32767  # ProjectionGeoKey: user-defined
    out[3075] = ct
    to_meter = p.get("to_meter", 1.0)
    if to_meter == 1.0:
        out[3076] = 9001
    else:
        out[3076] = 32767
        out[3077] = float(to_meter)
    proj = p["proj"]
    if proj in ("tmerc", "lcc1sp", "sterea"):
        out[3080], out[3081] = p["lon_0"], p["lat_0"]
        out[3092] = p.get("k_0", 1.0)
        out[3082], out[3083] = p["x_0"], p["y_0"]
    elif proj == "merc":
        out[3080], out[3081] = p["lon_0"], p.get("lat_0", 0.0)
        if "lat_ts" in p:
            out[3078] = p["lat_ts"]
        else:
            out[3092] = p.get("k_0", 1.0)
        out[3082], out[3083] = p["x_0"], p["y_0"]
    elif proj == "lcc":
        out[3078], out[3079] = p["lat_1"], p.get("lat_2", p["lat_1"])
        out[3084], out[3085] = p["lon_0"], p["lat_0"]
        out[3086], out[3087] = p["x_0"], p["y_0"]
        if p.get("k_0", 1.0) != 1.0:  # 2SP defs carrying a scale (Lambert zone grids)
            out[3092] = p["k_0"]
    elif proj == "aea":
        out[3078], out[3079] = p["lat_1"], p.get("lat_2", p["lat_1"])
        out[3080], out[3081] = p["lon_0"], p["lat_0"]
        out[3082], out[3083] = p["x_0"], p["y_0"]
    elif proj == "laea":
        out[3088], out[3089] = p["lon_0"], p["lat_0"]
        out[3082], out[3083] = p["x_0"], p["y_0"]
    elif proj == "stere":
        out[3095] = p["lon_0"]  # ProjStraightVertPoleLongGeoKey
        lat_ts = p.get("lat_ts")
        if lat_ts is not None and lat_ts != 0.0 and (lat_ts > 0.0) == (p["lat_0"] > 0.0):
            # GDAL variant B: the standard parallel goes into 3081, pole sign implied.
            out[3081] = lat_ts
        elif lat_ts is not None:
            out[3081] = p["lat_0"]
            out[3078] = lat_ts  # ambiguous sign/zero: explicit ProjStdParallel1
        else:
            out[3081] = p["lat_0"]
            out[3092] = p.get("k_0", 1.0)
        out[3082], out[3083] = p["x_0"], p["y_0"]
    elif proj == "eqc":
        out[3078] = p.get("lat_ts", 0.0)
        out[3080], out[3081] = p["lon_0"], p.get("lat_0", 0.0)
        out[3082], out[3083] = p["x_0"], p["y_0"]
    elif proj == "cea":
        out[3078] = p.get("lat_ts", 0.0)
        out[3080] = p["lon_0"]
        out[3082], out[3083] = p["x_0"], p["y_0"]
    elif proj == "omerc":
        out[3088], out[3089] = p["lon_0"], p["lat_0"]
        out[3094] = p["alpha"]
        out[3096] = p.get("gamma", p["alpha"])
        out[3093] = p.get("k_0", 1.0)
        out[3082], out[3083] = p["x_0"], p["y_0"]
    elif proj == "somerc":
        out[3088], out[3089] = p["lon_0"], p["lat_0"]
        out[3093] = p.get("k_0", 1.0)
        out[3082], out[3083] = p["x_0"], p["y_0"]
    return out


# --------------------------------------------------------------------------------------
# Round-4 EPSG breadth: US State Plane zones (NAD83 meters + common ftUS twins, NAD27
# GN7-2 zone) and Pulkovo 1942 Gauss-Kruger zone families
# --------------------------------------------------------------------------------------
# Control-point discipline: the LCC-2SP/ftUS math is pinned by the EPSG GN7-2 worked
# example through EPSG:32040 (NAD27 Texas South Central: 28d30'N 96dW -> E 2963503.91 /
# N 254759.80 US ft, tests/test_core.py), and the TM math by the GN7-2 OSGB example
# (EPSG:27700). Every zone definition below is additionally pinned by its EPSG-defined
# false-origin invariant (forward(lat_0, lon_0) == (x_0, y_0) exactly) in the tests.

_FT_US = 1200.0 / 3937.0

DATUMS.setdefault("Pulkovo42", (28.0, -130.0, -95.0))  # EPSG tfm 1254 (Russia, 3-param)

_EPSG_DEFS.update({
    # --- NAD27 (GN7-2 zone; coordinates in US survey feet, parameters stored in meters)
    32040: dict(proj="lcc", lat_1=28.0 + 23.0 / 60, lat_2=30.0 + 17.0 / 60,
                lat_0=27.0 + 50.0 / 60, lon_0=-99.0, x_0=2000000.0 * _FT_US, y_0=0.0,
                to_meter=_FT_US, ellps="clrk66", datum="NAD27",
                name="NAD27 / Texas South Central"),
    # --- NAD83 / State Plane, meters ---
    # Alabama (TM)
    26929: dict(proj="tmerc", lat_0=30.5, lon_0=-85.0 - 50.0 / 60, k_0=0.99996,
                x_0=200000.0, y_0=0.0, ellps="GRS80", name="NAD83 / Alabama East"),
    26930: dict(proj="tmerc", lat_0=30.0, lon_0=-87.5, k_0=0.999933333,
                x_0=600000.0, y_0=0.0, ellps="GRS80", name="NAD83 / Alabama West"),
    # Arizona (TM, zone FE 213360 m = 700000 international feet)
    26948: dict(proj="tmerc", lat_0=31.0, lon_0=-110.0 - 10.0 / 60, k_0=0.9999,
                x_0=213360.0, y_0=0.0, ellps="GRS80", name="NAD83 / Arizona East"),
    26949: dict(proj="tmerc", lat_0=31.0, lon_0=-111.0 - 55.0 / 60, k_0=0.9999,
                x_0=213360.0, y_0=0.0, ellps="GRS80", name="NAD83 / Arizona Central"),
    26950: dict(proj="tmerc", lat_0=31.0, lon_0=-113.75, k_0=0.999933333,
                x_0=213360.0, y_0=0.0, ellps="GRS80", name="NAD83 / Arizona West"),
    # California (LCC 2SP)
    26941: dict(proj="lcc", lat_1=40.0, lat_2=41.0 + 40.0 / 60, lat_0=39.0 + 20.0 / 60,
                lon_0=-122.0, x_0=2000000.0, y_0=500000.0, ellps="GRS80",
                name="NAD83 / California zone 1"),
    26942: dict(proj="lcc", lat_1=38.0 + 20.0 / 60, lat_2=39.0 + 50.0 / 60,
                lat_0=37.0 + 40.0 / 60, lon_0=-122.0, x_0=2000000.0, y_0=500000.0,
                ellps="GRS80", name="NAD83 / California zone 2"),
    26943: dict(proj="lcc", lat_1=37.0 + 4.0 / 60, lat_2=38.0 + 26.0 / 60,
                lat_0=36.5, lon_0=-120.5, x_0=2000000.0, y_0=500000.0,
                ellps="GRS80", name="NAD83 / California zone 3"),
    26944: dict(proj="lcc", lat_1=36.0, lat_2=37.25, lat_0=35.0 + 20.0 / 60,
                lon_0=-119.0, x_0=2000000.0, y_0=500000.0, ellps="GRS80",
                name="NAD83 / California zone 4"),
    26945: dict(proj="lcc", lat_1=34.0 + 2.0 / 60, lat_2=35.0 + 28.0 / 60,
                lat_0=33.5, lon_0=-118.0, x_0=2000000.0, y_0=500000.0,
                ellps="GRS80", name="NAD83 / California zone 5"),
    26946: dict(proj="lcc", lat_1=32.0 + 47.0 / 60, lat_2=33.0 + 53.0 / 60,
                lat_0=32.0 + 10.0 / 60, lon_0=-116.25, x_0=2000000.0, y_0=500000.0,
                ellps="GRS80", name="NAD83 / California zone 6"),
    # Colorado (LCC 2SP; FE/FN are exact metric equivalents of 3,000,000 / 1,000,000 ftUS)
    26953: dict(proj="lcc", lat_1=39.0 + 43.0 / 60, lat_2=40.0 + 47.0 / 60,
                lat_0=39.0 + 20.0 / 60, lon_0=-105.5, x_0=914401.8289, y_0=304800.6096,
                ellps="GRS80", name="NAD83 / Colorado North"),
    26954: dict(proj="lcc", lat_1=38.0 + 27.0 / 60, lat_2=39.75, lat_0=37.0 + 50.0 / 60,
                lon_0=-105.5, x_0=914401.8289, y_0=304800.6096, ellps="GRS80",
                name="NAD83 / Colorado Central"),
    26955: dict(proj="lcc", lat_1=37.0 + 14.0 / 60, lat_2=38.0 + 26.0 / 60,
                lat_0=36.0 + 40.0 / 60, lon_0=-105.5, x_0=914401.8289, y_0=304800.6096,
                ellps="GRS80", name="NAD83 / Colorado South"),
    # Florida (TM east/west, LCC north)
    26958: dict(proj="tmerc", lat_0=24.0 + 20.0 / 60, lon_0=-81.0, k_0=0.999941177,
                x_0=200000.0, y_0=0.0, ellps="GRS80", name="NAD83 / Florida East"),
    26959: dict(proj="tmerc", lat_0=24.0 + 20.0 / 60, lon_0=-82.0, k_0=0.999941177,
                x_0=200000.0, y_0=0.0, ellps="GRS80", name="NAD83 / Florida West"),
    26960: dict(proj="lcc", lat_1=29.0 + 35.0 / 60, lat_2=30.75, lat_0=29.0,
                lon_0=-84.5, x_0=600000.0, y_0=0.0, ellps="GRS80",
                name="NAD83 / Florida North"),
    # Illinois (TM)
    26971: dict(proj="tmerc", lat_0=36.0 + 40.0 / 60, lon_0=-88.0 - 20.0 / 60,
                k_0=0.999975, x_0=300000.0, y_0=0.0, ellps="GRS80",
                name="NAD83 / Illinois East"),
    26972: dict(proj="tmerc", lat_0=36.0 + 40.0 / 60, lon_0=-90.0 - 10.0 / 60,
                k_0=0.999941177, x_0=700000.0, y_0=0.0, ellps="GRS80",
                name="NAD83 / Illinois West"),
    # Montana / Nebraska (single-zone LCC states)
    32100: dict(proj="lcc", lat_1=45.0, lat_2=49.0, lat_0=44.25, lon_0=-109.5,
                x_0=600000.0, y_0=0.0, ellps="GRS80", name="NAD83 / Montana"),
    32104: dict(proj="lcc", lat_1=40.0, lat_2=43.0, lat_0=39.0 + 50.0 / 60,
                lon_0=-100.0, x_0=500000.0, y_0=0.0, ellps="GRS80", name="NAD83 / Nebraska"),
    # New York (TM east/central/west + LCC Long Island)
    32115: dict(proj="tmerc", lat_0=38.0 + 50.0 / 60, lon_0=-74.5, k_0=0.9999,
                x_0=150000.0, y_0=0.0, ellps="GRS80", name="NAD83 / New York East"),
    32116: dict(proj="tmerc", lat_0=40.0, lon_0=-76.0 - 35.0 / 60, k_0=0.9999,
                x_0=250000.0, y_0=0.0, ellps="GRS80", name="NAD83 / New York Central"),
    32117: dict(proj="tmerc", lat_0=40.0, lon_0=-78.0 - 35.0 / 60, k_0=0.9999,
                x_0=350000.0, y_0=0.0, ellps="GRS80", name="NAD83 / New York West"),
    32118: dict(proj="lcc", lat_1=40.0 + 40.0 / 60, lat_2=41.0 + 2.0 / 60,
                lat_0=40.0 + 10.0 / 60, lon_0=-74.0, x_0=300000.0, y_0=0.0,
                ellps="GRS80", name="NAD83 / New York Long Island"),
    # Pennsylvania (LCC 2SP)
    32128: dict(proj="lcc", lat_1=40.0 + 53.0 / 60, lat_2=41.0 + 57.0 / 60,
                lat_0=40.0 + 10.0 / 60, lon_0=-77.75, x_0=600000.0, y_0=0.0,
                ellps="GRS80", name="NAD83 / Pennsylvania North"),
    32129: dict(proj="lcc", lat_1=39.0 + 56.0 / 60, lat_2=40.0 + 58.0 / 60,
                lat_0=39.0 + 20.0 / 60, lon_0=-77.75, x_0=600000.0, y_0=0.0,
                ellps="GRS80", name="NAD83 / Pennsylvania South"),
    # Texas (LCC 2SP, five zones)
    32137: dict(proj="lcc", lat_1=34.0 + 39.0 / 60, lat_2=36.0 + 11.0 / 60,
                lat_0=34.0, lon_0=-101.5, x_0=200000.0, y_0=1000000.0,
                ellps="GRS80", name="NAD83 / Texas North"),
    32138: dict(proj="lcc", lat_1=32.0 + 8.0 / 60, lat_2=33.0 + 58.0 / 60,
                lat_0=31.0 + 40.0 / 60, lon_0=-98.5, x_0=600000.0, y_0=2000000.0,
                ellps="GRS80", name="NAD83 / Texas North Central"),
    32139: dict(proj="lcc", lat_1=30.0 + 7.0 / 60, lat_2=31.0 + 53.0 / 60,
                lat_0=29.0 + 40.0 / 60, lon_0=-100.0 - 20.0 / 60, x_0=700000.0,
                y_0=3000000.0, ellps="GRS80", name="NAD83 / Texas Central"),
    32140: dict(proj="lcc", lat_1=28.0 + 23.0 / 60, lat_2=30.0 + 17.0 / 60,
                lat_0=27.0 + 50.0 / 60, lon_0=-99.0, x_0=600000.0, y_0=4000000.0,
                ellps="GRS80", name="NAD83 / Texas South Central"),
    32141: dict(proj="lcc", lat_1=26.0 + 10.0 / 60, lat_2=27.0 + 50.0 / 60,
                lat_0=25.0 + 40.0 / 60, lon_0=-98.5, x_0=300000.0, y_0=5000000.0,
                ellps="GRS80", name="NAD83 / Texas South"),
    # Virginia (LCC 2SP)
    32146: dict(proj="lcc", lat_1=38.0 + 2.0 / 60, lat_2=39.0 + 12.0 / 60,
                lat_0=37.0 + 40.0 / 60, lon_0=-78.5, x_0=3500000.0, y_0=2000000.0,
                ellps="GRS80", name="NAD83 / Virginia North"),
    32147: dict(proj="lcc", lat_1=36.0 + 46.0 / 60, lat_2=37.0 + 58.0 / 60,
                lat_0=36.0 + 20.0 / 60, lon_0=-78.5, x_0=3500000.0, y_0=1000000.0,
                ellps="GRS80", name="NAD83 / Virginia South"),
    # Washington (LCC 2SP)
    32148: dict(proj="lcc", lat_1=47.5, lat_2=48.0 + 44.0 / 60, lat_0=47.0,
                lon_0=-120.0 - 50.0 / 60, x_0=500000.0, y_0=0.0, ellps="GRS80",
                name="NAD83 / Washington North"),
    32149: dict(proj="lcc", lat_1=45.0 + 50.0 / 60, lat_2=47.0 + 20.0 / 60,
                lat_0=45.0 + 20.0 / 60, lon_0=-120.5, x_0=500000.0, y_0=0.0,
                ellps="GRS80", name="NAD83 / Washington South"),
    # --- NAD83 / State Plane, US survey feet twins (parameters stay metric; to_meter
    # scales the coordinate axes — FE/FN are the zones' exact round-meter equivalents)
    2229: dict(proj="lcc", lat_1=34.0 + 2.0 / 60, lat_2=35.0 + 28.0 / 60, lat_0=33.5,
               lon_0=-118.0, x_0=2000000.0, y_0=500000.0, to_meter=_FT_US,
               ellps="GRS80", name="NAD83 / California zone 5 (ftUS)"),
    2263: dict(proj="lcc", lat_1=40.0 + 40.0 / 60, lat_2=41.0 + 2.0 / 60,
               lat_0=40.0 + 10.0 / 60, lon_0=-74.0, x_0=300000.0, y_0=0.0,
               to_meter=_FT_US, ellps="GRS80", name="NAD83 / New York Long Island (ftUS)"),
    2276: dict(proj="lcc", lat_1=32.0 + 8.0 / 60, lat_2=33.0 + 58.0 / 60,
               lat_0=31.0 + 40.0 / 60, lon_0=-98.5, x_0=600000.0, y_0=2000000.0,
               to_meter=_FT_US, ellps="GRS80",
               name="NAD83 / Texas North Central (ftUS)"),
})


# --------------------------------------------------------------------------------------
# The torch namespace for `xp`
# --------------------------------------------------------------------------------------
# The kernels above call numpy's ufunc names on tensors and on plain numbers alike (e.g.
# `xp.sqrt(1 - e2)`, `xp.maximum(0.0, t)`), and torch's functions refuse plain numbers. Each
# function here takes a number or a tensor: numbers alone go to numpy (a float comes back),
# and with a tensor among the arguments the others become tensors of its dtype and device.
# Integer tensors are computed in float64.


def _float_tensor(t: Any) -> Any:
    import torch

    return t if t.is_floating_point() else t.to(torch.float64)


def _host_number(v: Any) -> Any:
    return float(v) if np.ndim(v) == 0 else v


def _unary(np_fn: Any, torch_name: str):
    def fn(x: Any) -> Any:
        import torch

        if isinstance(x, torch.Tensor):
            return getattr(torch, torch_name)(_float_tensor(x))
        return _host_number(np_fn(x))

    fn.__name__ = np_fn.__name__
    return fn


def _binary(np_fn: Any, torch_name: str):
    def fn(a: Any, b: Any) -> Any:
        import torch

        ref = next((v for v in (a, b) if isinstance(v, torch.Tensor)), None)
        if ref is None:
            return _host_number(np_fn(a, b))
        ref = _float_tensor(ref)
        a, b = (torch.as_tensor(v, dtype=ref.dtype, device=ref.device) if not isinstance(v, torch.Tensor)
                else _float_tensor(v) for v in (a, b))
        return getattr(torch, torch_name)(a, b)

    fn.__name__ = np_fn.__name__
    return fn


class _TorchNamespace:
    """numpy's names, over tensors and plain numbers (see above)."""

    pi = math.pi
    abs = staticmethod(_unary(np.abs, "abs"))
    sign = staticmethod(_unary(np.sign, "sign"))
    sqrt = staticmethod(_unary(np.sqrt, "sqrt"))
    exp = staticmethod(_unary(np.exp, "exp"))
    log = staticmethod(_unary(np.log, "log"))
    sin = staticmethod(_unary(np.sin, "sin"))
    cos = staticmethod(_unary(np.cos, "cos"))
    tan = staticmethod(_unary(np.tan, "tan"))
    arcsin = staticmethod(_unary(np.arcsin, "asin"))
    arctan = staticmethod(_unary(np.arctan, "atan"))
    sinh = staticmethod(_unary(np.sinh, "sinh"))
    cosh = staticmethod(_unary(np.cosh, "cosh"))
    arcsinh = staticmethod(_unary(np.arcsinh, "asinh"))
    arctanh = staticmethod(_unary(np.arctanh, "atanh"))
    deg2rad = staticmethod(_unary(np.deg2rad, "deg2rad"))
    rad2deg = staticmethod(_unary(np.rad2deg, "rad2deg"))
    arctan2 = staticmethod(_binary(np.arctan2, "atan2"))
    maximum = staticmethod(_binary(np.maximum, "maximum"))

    @staticmethod
    def clip(x: Any, lo: Any, hi: Any) -> Any:
        import torch

        if not isinstance(x, torch.Tensor):
            if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
                ref = lo if isinstance(lo, torch.Tensor) else hi
                x = torch.as_tensor(x, dtype=_float_tensor(ref).dtype, device=ref.device)
            else:
                return _host_number(np.clip(x, lo, hi))
        return torch.clamp(_float_tensor(x), lo, hi)

    @staticmethod
    def where(cond: Any, a: Any, b: Any) -> Any:
        import torch

        ref = next((v for v in (cond, a, b) if isinstance(v, torch.Tensor)), None)
        if ref is None:
            return _host_number(np.where(cond, a, b))
        cond = torch.as_tensor(cond, device=ref.device)
        vals = [v for v in (a, b) if isinstance(v, torch.Tensor)]
        dtype = _float_tensor(vals[0]).dtype if vals else torch.float64
        a, b = (torch.as_tensor(v, dtype=dtype, device=ref.device) for v in (a, b))
        return torch.where(cond, a, b)


TORCH = _TorchNamespace()
