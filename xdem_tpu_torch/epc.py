"""The EPC elevation object: a PointCloud with vertical CRS handling, and point-cloud files.

Port of xdem_tpu/epc.py. ``to_vcrs`` transforms the elevations on the points' device in
float64 (``vcrs._transform_zz``). The LAS reader and writer are byte copies of xdem_tpu's, so
a LAS file written by either package reads back in the other to the same coordinates and
EPSG; the npz and text layouts are the same too. A data frame is read by its columns (duck
typing), without pandas.
"""

from __future__ import annotations

import os
import pathlib
import warnings
from typing import Any

import numpy as np
import torch

from xdem_tpu_torch.georef import CRS
from xdem_tpu_torch.pointcloud import PointCloud
from xdem_tpu_torch.vcrs import _transform_zz, _vcrs_from_user_input, grid_name_for

# The LAS 1.2 header as _write_las packs it (227 bytes), and the GeoKeyDirectory layout: the
# record id of the LASF_Projection VLR and the projected/geographic CS keys.
LAS_HEADER_SIZE = 227
LAS_GEOKEY_RECORD = 34735
LAS_KEY_PROJECTED, LAS_KEY_GEOGRAPHIC = 3072, 2048
LAS_USER_DEFINED = 32767


class EPC(PointCloud):
    """An elevation point cloud with vertical CRS handling.

    The first positional argument may be a point-cloud file path (LAS/npz/csv, see
    :func:`read_epc`), a data frame with ``x``/``y`` columns and the elevation in
    ``data_column``, or an existing PointCloud to wrap; coordinate arrays or tensors are
    taken as ``EPC(x, y, z, crs=...)`` or as ``x=``/``y=``/``z=`` keywords.
    """

    def __init__(self, *args: Any, data_column: str | None = None, vcrs: Any = None, **kwargs: Any):
        if args and isinstance(args[0], (np.ndarray, list, tuple, torch.Tensor)):
            super().__init__(*args, **({"data_column": data_column} if data_column else {}), **kwargs)
            self._vcrs = None
            if vcrs is not None:
                self.set_vcrs(vcrs)
            return
        filename_or_dataset = kwargs.pop("filename_or_dataset", None)
        if args:
            filename_or_dataset = args[0]
            if len(args) > 1:
                if data_column is not None:
                    raise TypeError("data_column given both positionally and as a keyword.")
                data_column = args[1]
            if len(args) > 2:
                raise TypeError("Too many positional arguments for a file/dataset input.")
        if filename_or_dataset is not None:
            src = filename_or_dataset
            if isinstance(src, (str, pathlib.Path)):
                if not os.path.isfile(str(src)):
                    raise FileNotFoundError(f"{src} does not exist")
                src = read_epc(str(src), crs=kwargs.pop("crs", None))
            if isinstance(src, PointCloud):
                wrap_crs = kwargs.pop("crs", None)
                if wrap_crs is not None and CRS(wrap_crs) != src.crs:
                    raise ValueError(
                        "Wrapping does not reproject: the PointCloud is already in "
                        f"{src.crs}; call .to_crs({wrap_crs}) first."
                    )
                col = data_column or src.data_column
                super().__init__(x=src.x, y=src.y, z=src.z, crs=src.crs, data_column=col,
                                 aux_columns=getattr(src, "aux_columns", None), **kwargs)
                if vcrs is None:  # wrapping an EPC carries its vertical CRS
                    vcrs = getattr(src, "_vcrs", None)
            elif hasattr(src, "columns"):  # a data frame with x/y and elevation columns
                col = data_column or "z"
                if not {"x", "y", col}.issubset(set(src.columns)):
                    raise ValueError(
                        f"DataFrame input needs 'x', 'y' and '{col}' columns "
                        f"(got {list(src.columns)}); pass data_column= for the elevation."
                    )
                crs = kwargs.pop("crs", None)
                if crs is None:
                    raise ValueError("DataFrame input carries no CRS; pass crs=...")
                super().__init__(x=np.asarray(src["x"], np.float64), y=np.asarray(src["y"], np.float64),
                                 z=np.asarray(src[col], np.float64), crs=crs, data_column=col, **kwargs)
            else:
                raise TypeError(
                    "First argument must be a file path, DataFrame or PointCloud "
                    f"(got {type(src).__name__}); or pass x=/y=/z= arrays."
                )
        else:
            if data_column is not None:
                kwargs.setdefault("data_column", data_column)
            super().__init__(**kwargs)
        self._vcrs = None
        if vcrs is not None:
            self.set_vcrs(vcrs)

    @property
    def vcrs(self) -> Any:
        return self._vcrs

    @property
    def vcrs_name(self) -> str | None:
        return None if self._vcrs is None else str(self._vcrs)

    @property
    def vcrs_grid(self) -> str | None:
        """Grid name of the vertical CRS."""
        return grid_name_for(self._vcrs)

    @property
    def ccrs(self):
        """Compound (horizontal + vertical) CRS description string."""
        if self._vcrs is None:
            return None
        return f"{self.crs!r} + {self._vcrs}"

    def set_vcrs(self, new_vcrs: Any) -> None:
        self._vcrs = _vcrs_from_user_input(new_vcrs)

    def to_vcrs(self, vcrs: Any, force_source_vcrs: Any = None, *, inplace: bool = False) -> "EPC | None":
        """Transform the elevations to another vertical CRS on the points' device in float64;
        ``inplace=True`` mutates this EPC and returns None."""
        src = self._vcrs if force_source_vcrs is None else _vcrs_from_user_input(force_source_vcrs)
        if src is None:
            raise ValueError("The EPC has no vertical CRS defined; set one with set_vcrs().")
        dst = _vcrs_from_user_input(vcrs)
        if src == dst:
            warnings.warn("Source and destination vertical CRS are the same, skipping vertical transformation.",
                          category=UserWarning)
            return None
        zz = _transform_zz(src, dst, self.crs, self.x, self.y, self.z)
        if inplace:
            self.z = zz
            self._vcrs = dst
            return None
        out = self.copy()
        out.z = zz
        out._vcrs = dst
        return out

    def coregister_3d(self, reference_elev: Any, coreg_method: Any = None, inlier_mask: Any = None,
                      bias_vars: Any = None, **kwargs: Any) -> Any:
        """Coregister THIS EPC to a reference elevation dataset (``self`` is the to-be-aligned
        data, the argument the reference; Nuth & Kääb by default); returns the moved EPC."""
        if coreg_method is None:
            from xdem_tpu_torch.coreg import NuthKaab

            coreg_method = NuthKaab()
        return coreg_method.fit_and_apply(reference_elev, self.copy(), inlier_mask=inlier_mask,
                                          bias_vars=bias_vars, **kwargs)


def read_epc(path: str, crs: Any = None) -> EPC:
    """Read an EPC from disk; the format is picked by extension.

    - ``.npz``: arrays x, y, z, crs (as :func:`write_epc` and the examples write them)
    - ``.las``: ASPRS LAS 1.0-1.4, any point format (xyz from the scaled integers of every
      record; the EPSG from the GeoKeyDirectory VLR when present, else pass ``crs=``)
    - ``.csv`` / ``.txt`` / ``.xyz``: whitespace- or comma-delimited x y z columns, optional
      header line; pass ``crs=`` (no text convention carries one)
    """
    lower = path.lower()
    if lower.endswith(".npz"):
        data = np.load(path)
        return EPC(x=data["x"], y=data["y"], z=data["z"], crs=int(data["crs"]) if crs is None else crs)
    if lower.endswith(".laz"):
        raise OSError("Compressed LAZ is not supported; decompress to .las first.")
    if lower.endswith(".las"):
        x, y, z, file_epsg = _read_las(path)
        crs = crs if crs is not None else file_epsg
        if crs is None:
            raise ValueError(f"'{path}' carries no GeoKey CRS; pass read_epc(path, crs=...) explicitly.")
        return EPC(x=x, y=y, z=z, crs=crs)
    if lower.endswith((".csv", ".txt", ".xyz")):
        if crs is None:
            raise ValueError("Text point files carry no CRS; pass read_epc(path, crs=...).")
        with open(path) as f:
            first = f.readline()
        delim = "," if "," in first else None
        tokens = first.replace(",", " ").split()
        try:  # a header line is one whose first token is not a number
            float(tokens[0])
            has_header = False
        except (ValueError, IndexError):
            has_header = bool(tokens)
        arr = np.loadtxt(path, delimiter=delim, skiprows=1 if has_header else 0, ndmin=2)
        if arr.shape[1] < 3:
            raise ValueError(f"'{path}': expected at least 3 columns (x y z), got {arr.shape[1]}.")
        return EPC(x=arr[:, 0], y=arr[:, 1], z=arr[:, 2], crs=crs)
    raise ValueError(f"Unsupported point-cloud format: '{path}' (use .npz, .las, .csv/.txt/.xyz).")


def _xyz_host(epc: PointCloud) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    return tuple(v.detach().cpu().numpy() for v in (epc.x, epc.y, epc.z))  # type: ignore[return-value]


def write_epc(path: str, epc: PointCloud) -> None:
    """Write a point cloud to .las (ASPRS LAS 1.2, point format 0, EPSG in a GeoKey VLR),
    .npz, or delimited text (.csv/.txt/.xyz; header x,y,z)."""
    lower = path.lower()
    if lower.endswith(".npz"):
        if not epc.crs.epsg:
            raise ValueError(
                "The npz layout stores the CRS as an EPSG code, but this point cloud's CRS "
                f"({epc.crs}) has none. Reproject to an EPSG-coded CRS first, or write text."
            )
        x, y, z = _xyz_host(epc)
        np.savez(path, x=x, y=y, z=z, crs=np.int64(epc.crs.epsg))
    elif lower.endswith(".las"):
        _write_las(path, epc)
    elif lower.endswith((".csv", ".txt", ".xyz")):
        delim = "," if lower.endswith(".csv") else " "
        np.savetxt(path, np.column_stack(_xyz_host(epc)), delimiter=delim, header=delim.join(("x", "y", "z")),
                   comments="")
    else:
        raise ValueError(f"Unsupported output format: '{path}' (use .las, .npz or .csv/.txt/.xyz).")


def _write_las(path: str, epc: PointCloud) -> None:
    """Minimal ASPRS LAS 1.2 writer: point data record format 0 (20 bytes: scaled-int32 xyz
    and zeroed attributes), millimetre coordinate scale, and the projected or geographic EPSG
    in a LASF_Projection GeoKeyDirectory VLR (record 34735), so :func:`read_epc` and any
    standard LAS reader recover the CRS."""
    import struct

    if not epc.crs.epsg:
        raise ValueError(
            "LAS stores the CRS as an EPSG GeoKey, but this point cloud's CRS "
            f"({epc.crs}) has none. Reproject to an EPSG-coded CRS first."
        )
    x, y, z = _xyz_host(epc)
    n = int(x.size)
    ox = float(np.min(x)) if n else 0.0
    oy = float(np.min(y)) if n else 0.0
    oz = float(np.min(z)) if n else 0.0
    is_geographic = epc.crs.is_geographic if hasattr(epc.crs, "is_geographic") else False

    # mm for projected coordinates, 1e-7 deg (~1 cm) for geographic ones, z in mm; an axis
    # coarsens by decades until its span fits int32.
    def _fit_scale(base: float, span: float) -> float:
        s = base
        while span / s > 0.9 * 2**31:
            s *= 10.0
        return s

    base = 1e-7 if is_geographic else 1e-3
    scale_x = _fit_scale(base, (float(np.max(x)) - ox) if n else 0.0)
    scale_y = _fit_scale(base, (float(np.max(y)) - oy) if n else 0.0)
    zscale = _fit_scale(1e-3, (float(np.max(z)) - oz) if n else 0.0)
    cs_key = LAS_KEY_GEOGRAPHIC if is_geographic else LAS_KEY_PROJECTED
    keys = [(1, 1, 0, 2), (1024, 0, 1, 2 if is_geographic else 1), (cs_key, 0, 1, int(epc.crs.epsg))]
    keys[0] = (1, 1, 0, len(keys) - 1)
    geokeys = b"".join(struct.pack("<4H", *k) for k in keys)
    vlr = struct.pack("<H16sHH32s", 0, b"LASF_Projection", LAS_GEOKEY_RECORD, len(geokeys),
                      b"GeoKeyDirectory") + geokeys

    point_offset = LAS_HEADER_SIZE + len(vlr)
    header = struct.pack(
        "<4sHHIHH8sBB32s32sHHHII", b"LASF", 0, 0, 0, 0, 0, b"", 1, 2,
        b"xdem_tpu", b"xdem_tpu write_epc", 1, 2026, LAS_HEADER_SIZE, point_offset, 1,
    )
    header += struct.pack("<BHI", 0, 20, n)  # point format 0, 20-byte records, count
    header += struct.pack("<5I", n, 0, 0, 0, 0)  # points by return
    header += struct.pack("<6d", scale_x, scale_y, zscale, ox, oy, oz)
    header += struct.pack("<6d",
                          float(np.max(x)) if n else 0.0, ox,
                          float(np.max(y)) if n else 0.0, oy,
                          float(np.max(z)) if n else 0.0, oz)
    assert len(header) == LAS_HEADER_SIZE, len(header)

    records = np.zeros((n, 20), dtype=np.uint8)
    xyz_i = np.column_stack([
        np.round((x - ox) / scale_x), np.round((y - oy) / scale_y), np.round((z - oz) / zscale)
    ]).astype("<i4")
    records[:, :12] = xyz_i.view(np.uint8).reshape(n, 12)
    with open(path, "wb") as f:
        f.write(header)
        f.write(vlr)
        f.write(records.tobytes())


def _read_las(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray, int | None]:
    """Minimal ASPRS LAS reader: xyz for any point format (the first 12 bytes of every record
    are scaled-int32 x, y, z in formats 0-10), and the EPSG from the LASF_Projection
    GeoKeyDirectory VLR when there is one."""
    import struct

    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"LASF":
        raise OSError(f"'{path}' is not a LAS file (bad signature).")
    ver_major, ver_minor = buf[24], buf[25]
    header_size = struct.unpack_from("<H", buf, 94)[0]
    point_offset = struct.unpack_from("<I", buf, 96)[0]
    n_vlrs = struct.unpack_from("<I", buf, 100)[0]
    point_len = struct.unpack_from("<H", buf, 105)[0]
    n_points = struct.unpack_from("<I", buf, 107)[0]
    if ver_major == 1 and ver_minor >= 4 and header_size >= 255:
        n64 = struct.unpack_from("<Q", buf, 247)[0]
        if n64:  # LAS 1.4 moves the authoritative count; the legacy field may be zero
            n_points = n64
    sx, sy, sz, ox, oy, oz = struct.unpack_from("<6d", buf, 131)

    epsg = None
    pos = header_size
    for _ in range(n_vlrs):
        if pos + 54 > len(buf):
            break
        record_id, rec_len = struct.unpack_from("<HH", buf, pos + 18)
        if record_id == LAS_GEOKEY_RECORD and rec_len >= 8 and pos + 54 + rec_len <= len(buf):
            keys = np.frombuffer(buf, "<u2", count=rec_len // 2, offset=pos + 54)
            # A corrupt key count degrades to "no CRS found"
            n_keys = min(int(keys[3]), (len(keys) - 4) // 4)
            for k in range(n_keys):
                key_id, loc, _cnt, val = keys[4 + 4 * k: 8 + 4 * k]
                if key_id in (LAS_KEY_PROJECTED, LAS_KEY_GEOGRAPHIC) and loc == 0:
                    if int(val) == LAS_USER_DEFINED:  # not a real EPSG code
                        continue
                    epsg = int(val)
                    if key_id == LAS_KEY_PROJECTED:
                        break
        pos += 54 + rec_len

    end = point_offset + n_points * point_len
    if point_len < 12 or end > len(buf):
        raise OSError(f"'{path}': truncated LAS point data.")
    records = np.frombuffer(buf, np.uint8, count=n_points * point_len, offset=point_offset)
    xyz_i = records.reshape(n_points, point_len)[:, :12].copy().view("<i4")
    return (xyz_i[:, 0] * sx + ox, xyz_i[:, 1] * sy + oy, xyz_i[:, 2] * sz + oz, epsg)
