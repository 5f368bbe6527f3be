"""Raster I/O through the native GeoTIFF codec (``native/geotiff.cpp``).

Upstream xdem reads and writes rasters through rasterio/GDAL. This package ships its own C++
codec instead, a byte-for-byte copy of xdem_tpu/native/geotiff.cpp (classic TIFF and BigTIFF,
striped or tiled, none/LZW/DEFLATE/PackBits compression, horizontal and floating-point
predictors, u8-f64 samples; writes single-band float32 DEFLATE with the floating-point
predictor and GeoTIFF keys). ``g++`` compiles it with zlib at first use into
``xdem_tpu_torch/_build/`` (never at import), and ``ctypes`` loads it. There is no fallback:
without ``g++`` or zlib's header the first read or write raises, naming what is missing.

Pixels are decoded on the host; a raster's data then goes to its tensor device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from xdem_tpu_torch.georef import Affine

_LIB = None

_SRC = Path(__file__).resolve().parent / "native" / "geotiff.cpp"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


class _GtInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("bands", ctypes.c_uint32),
        ("transform", ctypes.c_double * 6),
        ("epsg", ctypes.c_int32),
        ("nodata", ctypes.c_double),
        ("has_nodata", ctypes.c_int32),
        ("raster_type", ctypes.c_int32),
    ]


def library_path() -> Path:
    """Where the codec's build goes: a directory keyed by the source and the flags."""
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"geotiff-{key}" / "libxdemtiff.so"


def build_library() -> Path:
    """Compile the codec with g++ and zlib (once per source and flags); returns the library."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ was not found on PATH: the GeoTIFF codec (native/geotiff.cpp) cannot be built.")
    out.parent.mkdir(parents=True, exist_ok=True)
    # Build under a temporary name and rename: concurrent processes never load a partial file.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [cxx, *_CXX_FLAGS, str(_SRC), "-o", tmp, "-lz"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        missing = " zlib's header (zlib.h) is missing." if "zlib.h" in proc.stderr else ""
        raise RuntimeError(f"Failed to build the GeoTIFF codec with {' '.join(cmd)}:{missing}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.gt_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_GtInfo)]
        lib.gt_info.restype = ctypes.c_int
        lib.gt_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)]
        lib.gt_read.restype = ctypes.c_int
        lib.gt_write.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int32,
            ctypes.c_double,
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.c_char_p,
        ]
        lib.gt_write.restype = ctypes.c_int
        lib.gt_last_error.restype = ctypes.c_char_p
        lib.gt_metadata.argtypes = [ctypes.c_char_p]
        lib.gt_metadata.restype = ctypes.c_char_p
        lib.gt_citation.argtypes = [ctypes.c_char_p]
        lib.gt_citation.restype = ctypes.c_char_p
        lib.gt_geokeys.argtypes = [ctypes.c_char_p]
        lib.gt_geokeys.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _err() -> str:
    return _lib().gt_last_error().decode()


def _parse_geokeys(serialized: str) -> dict:
    """Parse gt_geokeys output ('s<key>=<int>;' / 'd<key>=<v,..>;') into {key: int|tuple}."""
    keys: dict = {}
    for item in serialized.split(";"):
        if not item or "=" not in item:
            continue
        head, val = item.split("=", 1)
        try:
            kid = int(head[1:])
            if head[0] == "s":
                keys[kid] = int(val)
            elif head[0] == "d":
                keys[kid] = tuple(float(v) for v in val.split(","))
        except ValueError:
            continue
    return keys


def _serialize_geokeys(keys: dict) -> bytes:
    """Inverse of _parse_geokeys, ascending key order (a GeoTIFF requirement)."""
    parts = []
    for kid in sorted(keys):
        v = keys[kid]
        if isinstance(v, (tuple, list)):
            parts.append(f"d{kid}=" + ",".join(repr(float(x)) for x in v))
        elif isinstance(v, float):
            parts.append(f"d{kid}={v!r}")
        else:
            parts.append(f"s{kid}={int(v)}")
    return (";".join(parts) + ";").encode() if parts else b""


def read_raster(path: str, raster_cls=None):
    """Read a GeoTIFF into a Raster (band 1, nodata converted to NaN)."""
    if raster_cls is None:
        from xdem_tpu_torch.raster import Raster as raster_cls  # type: ignore[no-redef]

    lib = _lib()
    info = _GtInfo()
    if lib.gt_info(path.encode(), ctypes.byref(info)) != 0:
        raise OSError(f"Cannot read GeoTIFF '{path}': {_err()}")
    # Plausibility guard before allocating: a corrupt header claiming billions of pixels
    # would otherwise OOM the process on first touch (lazy overcommit + OOM killer). Even
    # at extreme DEFLATE ratios, pixel bytes cannot exceed ~1e4x the file size.
    n_px = int(info.height) * int(info.width)
    if n_px == 0 or n_px * 4 > os.path.getsize(path) * 10_000 + (1 << 24):
        raise OSError(
            f"Cannot read GeoTIFF '{path}': implausible dimensions "
            f"{info.height}x{info.width} for a {os.path.getsize(path)}-byte file."
        )
    data = np.empty((info.height, info.width), dtype=np.float32)
    if lib.gt_read(path.encode(), data.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) != 0:
        raise OSError(f"Cannot decode GeoTIFF '{path}': {_err()}")
    nodata = None
    if info.has_nodata:
        nodata = float(info.nodata)
        with np.errstate(invalid="ignore"):
            data = np.where(data == np.float32(nodata), np.nan, data)
    transform = Affine(*info.transform)
    if info.epsg:
        crs = int(info.epsg)
    else:
        # No (or user-defined) EPSG geokey. Resolution order matches GDAL's ingestion of
        # custom CRSs (upstream xdem reads these via rasterio/pyproj): (1) citation WKT
        # (GTCitation/PCSCitation), (2) parameter GeoKeys
        # (ProjCoordTransGeoKey 3075 + ProjNatOrigin*/ProjFalse*/... doubles). A file whose
        # GeoKeys we cannot resolve warns — never a silent EPSG:4326 fallback.
        cit = lib.gt_citation(path.encode()).decode(errors="replace")
        crs = None
        cit_err = geo_err = None
        if cit:
            from xdem_tpu_torch.georef import CRS as _CRS

            try:
                crs = _CRS(cit)
            except (ValueError, NotImplementedError, KeyError) as err:
                cit_err = err
        if crs is None:
            geokeys = _parse_geokeys(lib.gt_geokeys(path.encode()).decode(errors="replace"))
            if geokeys.get(3075) or geokeys.get(1024) == 2 or geokeys.get(2048):
                from xdem_tpu_torch.georef import CRS as _CRS
                from xdem_tpu_torch.projections import projdef_from_geokeys

                try:
                    crs = _CRS(projdef_from_geokeys(geokeys))
                except (ValueError, NotImplementedError, KeyError) as err:
                    geo_err = err
        if crs is None:
            import warnings as _warnings

            # 32767 in GeographicType (2048) / ProjectedCSType (3072) marks a user-defined
            # CRS: even with nothing to parse (no citation, no parameter keys), assuming
            # 4326 would be silently wrong — only a bare, CRS-key-free file skips the warn.
            user_defined = 32767 in (geokeys.get(2048), geokeys.get(3072))
            if cit_err is not None or geo_err is not None or user_defined:
                _warnings.warn(
                    f"GeoTIFF '{path}' carries a user-defined CRS that could not be resolved "
                    f"(citation: {cit_err}; geokeys: {geo_err}); assuming EPSG:4326. Pass an "
                    f"explicit crs= or re-export the file with an EPSG code.",
                    UserWarning,
                )
            crs = 4326
    md = lib.gt_metadata(path.encode()).decode(errors="replace")
    tags = {}
    if md:
        import re as _re
        from xml.sax.saxutils import unescape as _unescape

        tags = {_unescape(m.group(1), {"&quot;": '"'}): _unescape(m.group(2), {"&quot;": '"'})
                for m in _re.finditer(r'<Item name="([^"]+)">([^<]*)</Item>', md)}
    # Pixel interpretation: RasterPixelIsPoint geokey (foreign files) or our metadata item
    area_or_point = "Point" if (info.raster_type == 2
                                or tags.get("AREA_OR_POINT") == "Point") else "Area"
    tags.pop("AREA_OR_POINT", None)
    # Tags must reach the constructor: DEM parses its vertical CRS from them at init
    out = raster_cls(data, transform=transform, crs=crs, nodata=nodata, tags=tags,
                     area_or_point=area_or_point)
    return out


def write_raster(path: str, raster, nodata: float | None = None, predictor: int = 3) -> None:
    """Write a Raster as a single-band float32 DEFLATE GeoTIFF.

    `predictor=3` (default; the TIFF floating-point predictor GDAL uses via PREDICTOR=3)
    typically shrinks DEM rasters 2-3x vs plain DEFLATE; pass `predictor=1` for readers
    predating it.
    """
    lib = _lib()
    data = np.ascontiguousarray(raster.get_nanarray(), dtype=np.float32)
    use_nodata = nodata if nodata is not None else (raster.nodata if raster.nodata is not None else -9999.0)
    data = np.where(np.isfinite(data), data, np.float32(use_nodata))
    transform = (ctypes.c_double * 6)(*[float(v) for v in tuple(raster.transform)])
    epsg = 0
    citation = b""
    geokeys_extra = b""
    if raster.crs is not None:
        epsg = int(raster.crs.epsg or 0)
        if epsg == 0 or epsg > 65535:  # geokey values are SHORTs: carry the CRS as WKT
            epsg = 0
            citation = raster.crs.to_wkt().encode()
            # ... and as parameter GeoKeys (ProjCoordTrans + doubles), the GDAL-interop
            # encoding for non-EPSG CRSs — readers that ignore citations still resolve it
            projdef = getattr(raster.crs, "projdef", None)
            if projdef is not None:
                from xdem_tpu_torch.projections import geokeys_from_projdef

                try:
                    keys = geokeys_from_projdef(projdef)
                except (ValueError, NotImplementedError, KeyError):
                    keys = {}
                if keys:
                    if projdef.get("proj") != "longlat":
                        keys[3072] = 32767  # ProjectedCSTypeGeoKey: user-defined
                    geokeys_extra = _serialize_geokeys(keys)
    tags = dict(getattr(raster, "tags", None) or {})
    if getattr(raster, "area_or_point", "Area") == "Point":
        tags["AREA_OR_POINT"] = "Point"  # GDAL metadata convention; geokey 1025 also set
    if tags:
        from xml.sax.saxutils import escape as _escape

        items = "".join(
            f'<Item name="{_escape(str(k), {chr(34): "&quot;"})}">'
            f'{_escape(str(v), {chr(34): "&quot;"})}</Item>'
            for k, v in sorted(tags.items())
        )
        metadata = f"<GDALMetadata>{items}</GDALMetadata>".encode()
    else:
        metadata = b""
    rc = lib.gt_write(
        path.encode(),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        data.shape[0],
        data.shape[1],
        transform,
        epsg,
        float(use_nodata),
        1,
        metadata,
        int(predictor),
        citation,
        1 if getattr(raster, "area_or_point", "Area") == "Point" else 0,
        geokeys_extra,
    )
    if rc != 0:
        raise OSError(f"Cannot write GeoTIFF '{path}': {_err()}")


# ---------------------------------------------------------------------------------------
# Streaming I/O for out-of-core tiling (pure Python, uncompressed striped GeoTIFF)
# ---------------------------------------------------------------------------------------
# The C++ codec reads/writes whole rasters. Out-of-core tiled processing (terrain attributes
# on rasters whose attribute stack exceeds memory, reference terrain.py:412-466) instead
# streams row bands: the writer pre-computes the uncompressed strip layout so each band can be
# written as soon as its tile is computed; the reader decodes only the requested rows.

import struct as _struct


class StreamingRasterWriter:
    """Create an uncompressed striped float32 GeoTIFF and fill it by row bands.

    The full IFD (with precomputed strip offsets) is written at creation; `write_rows` then
    pwrites pixel data at the right offsets, so tiles may arrive in any order and peak memory
    is one row band. Tag layout mirrors native/geotiff.cpp so the C++ reader round-trips it.

    Rasters whose pixel data would overflow classic TIFF's 32-bit offsets are written as
    BigTIFF automatically (or force with ``bigtiff=True``); both readers here handle it.
    """

    def __init__(self, path: str, shape: tuple[int, int], transform: Affine, crs=None,
                 nodata: float = -9999.0, rows_per_strip: int = 64, bigtiff: bool | None = None,
                 area_or_point: str = "Area"):
        h, w = int(shape[0]), int(shape[1])
        self.path = path
        self.shape = (h, w)
        self.nodata = float(nodata)
        self.rows_per_strip = int(rows_per_strip)
        n_strips = (h + rows_per_strip - 1) // rows_per_strip
        if bigtiff is None:
            # Everything before the last byte must fit 32-bit offsets: pixel data plus the
            # strip offset/count arrays (8 bytes/strip classic, and tall-skinny rasters can
            # have millions of strips) plus a generous fixed-tag allowance.
            bigtiff = (h * w * 4 + n_strips * 16 + 65_536) >= 2**32
        self.bigtiff = bool(bigtiff)

        from xdem_tpu_torch.georef import CRS as _CRS

        epsg = 0
        geographic = False
        citation = b""
        if crs is not None:
            c = _CRS(crs)
            epsg = int(c.epsg or 0)
            geographic = not c.is_projected
            if epsg == 0 or epsg > 65535:  # geokey values are SHORTs: carry WKT citation
                epsg = 0
                citation = c.to_wkt().encode()[:65000]

        t = tuple(transform)
        # ModelPixelScale (scale_y positive; row axis implied negative by tiepoint convention)
        pixel_scale = (abs(t[0]), abs(t[4]), 0.0)
        tiepoint = (0.0, 0.0, 0.0, t[2], t[5], 0.0)
        nodata_str = (repr(self.nodata) + "\x00").encode()
        ascii_params = citation + b"|" if citation else b""
        # GeoKey IDs must be ascending: 1024, 1025, [1026 citation], 2048/3072
        geokeys = _struct.pack(
            "<12H",
            1, 1, 0, 3 + (1 if citation else 0),
            1024, 0, 1, (2 if geographic else 1),
            1025, 0, 1, (2 if area_or_point == "Point" else 1),
        )
        if citation:
            geokeys += _struct.pack("<4H", 1026, 34737, len(ascii_params), 0)
            ascii_params += b"\x00"
        geokeys += _struct.pack(
            "<4H", (2048 if geographic else 3072), 0, 1,
            (epsg if epsg else (32767 if citation else 0)),
        )

        big = self.bigtiff
        off_type = 16 if big else 4  # strip offsets/counts: LONG8 in BigTIFF
        # Aux data blocks placed right after the IFD
        tags: list[tuple[int, int, int, object]] = [
            (256, 4, 1, w),            # ImageWidth
            (257, 4, 1, h),            # ImageLength
            (258, 3, 1, 32),           # BitsPerSample
            (259, 3, 1, 1),            # Compression = none
            (262, 3, 1, 1),            # Photometric
            (273, off_type, n_strips, "strip_offsets"),
            (277, 3, 1, 1),            # SamplesPerPixel
            (278, 4, 1, rows_per_strip),
            (279, off_type, n_strips, "strip_counts"),
            (284, 3, 1, 1),            # PlanarConfig
            (339, 3, 1, 3),            # SampleFormat = IEEE float
            (33550, 12, 3, pixel_scale),
            (33922, 12, 6, tiepoint),
            (34735, 3, len(geokeys) // 2, geokeys),
            (42113, 2, len(nodata_str), nodata_str),
        ]
        if ascii_params:
            tags.insert(-1, (34737, 2, len(ascii_params), ascii_params))

        header_size = 16 if big else 8
        entry_size = 20 if big else 12
        ifd_size = (8 + len(tags) * entry_size + 8) if big else (2 + len(tags) * entry_size + 4)
        aux_off = header_size + ifd_size
        inline_cap = 8 if big else 4

        strip_counts = [min(rows_per_strip, h - i * rows_per_strip) * w * 4 for i in range(n_strips)]

        def _sizeof(ttype, count):
            return {2: 1, 3: 2, 4: 4, 12: 8, 16: 8}[ttype] * count

        # First pass: compute offsets for oversized values
        offsets: dict[int, int] = {}
        pos = aux_off
        for tag, ttype, count, val in tags:
            size = _sizeof(ttype, count)
            if size > inline_cap:
                offsets[tag] = pos
                pos += size + (size % 2)
        data_start = pos
        strip_offsets = []
        p = data_start
        for sc in strip_counts:
            strip_offsets.append(p)
            p += sc
        self._strip_offsets = strip_offsets

        def _pack_value(tag, ttype, count, val) -> bytes:
            if val == "strip_offsets":
                return _struct.pack(f"<{count}{'Q' if big else 'I'}", *strip_offsets)
            if val == "strip_counts":
                return _struct.pack(f"<{count}{'Q' if big else 'I'}", *strip_counts)
            if ttype == 12:
                return _struct.pack(f"<{count}d", *val)
            if ttype == 2:
                return bytes(val)
            if isinstance(val, bytes):
                return val
            fmt = {3: "H", 4: "I", 16: "Q"}[ttype]
            vals = val if isinstance(val, (tuple, list)) else (val,)
            return _struct.pack(f"<{count}{fmt}", *vals)

        buf = bytearray()
        if big:
            buf += b"II+\x00" + _struct.pack("<HHQ", 8, 0, 16)
            buf += _struct.pack("<Q", len(tags))
        else:
            buf += b"II*\x00" + _struct.pack("<I", 8)
            buf += _struct.pack("<H", len(tags))
        ptr_fmt = "Q" if big else "I"
        aux_bytes = bytearray()
        for tag, ttype, count, val in tags:
            size = _sizeof(ttype, count)
            packed = _pack_value(tag, ttype, count, val)
            cnt_fmt = "Q" if big else "I"
            if size > inline_cap:
                off = offsets[tag]
                buf += _struct.pack(f"<HH{cnt_fmt}{ptr_fmt}", tag, ttype, count, off)
                aux_bytes += packed
                if size % 2:
                    aux_bytes += b"\x00"
            else:
                buf += _struct.pack(f"<HH{cnt_fmt}", tag, ttype, count) + packed.ljust(inline_cap, b"\x00")
        buf += _struct.pack(f"<{ptr_fmt}", 0)  # next IFD
        buf += aux_bytes
        assert len(buf) == data_start, (len(buf), data_start)

        self._f = open(path, "w+b")
        self._f.write(buf)
        # Pre-size the file so out-of-order strip writes are valid
        self._f.truncate(data_start + sum(strip_counts))

    def write_rows(self, row0: int, block: np.ndarray) -> None:
        """Write `block` (k, W) at absolute row `row0` (NaN converted to nodata)."""
        h, w = self.shape
        block = np.ascontiguousarray(block, dtype="<f4")
        assert block.shape[1] == w and 0 <= row0 and row0 + block.shape[0] <= h
        block = np.where(np.isfinite(block), block, np.float32(self.nodata))
        self._f.seek(self._strip_offsets[0] + row0 * w * 4)
        self._f.write(block.tobytes())

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_rows(path: str, row0: int, nrows: int) -> np.ndarray:
    """Read rows [row0, row0+nrows) of band 1 from an uncompressed striped float32 GeoTIFF
    (as produced by StreamingRasterWriter). Nodata is converted to NaN."""
    with open(path, "rb") as f:
        head = f.read(16)
        if head[:4] == b"II*\x00":
            big = False
            (ifd_off,) = _struct.unpack("<I", head[4:8])
            f.seek(ifd_off)
            (n_tags,) = _struct.unpack("<H", f.read(2))
        elif head[:4] == b"II+\x00" and _struct.unpack("<HH", head[4:8]) == (8, 0):
            big = True
            (ifd_off,) = _struct.unpack("<Q", head[8:16])
            f.seek(ifd_off)
            (n_tags,) = _struct.unpack("<Q", f.read(8))
        else:
            raise OSError(f"'{path}' is not a little-endian classic TIFF or BigTIFF.")
        inline_cap = 8 if big else 4
        entry_fmt = "<HHQ8s" if big else "<HHI4s"
        entry_size = 20 if big else 12
        tags = {}
        for _ in range(n_tags):
            tag, ttype, count, val = _struct.unpack(entry_fmt, f.read(entry_size))
            tags[tag] = (ttype, count, val)

        def _values(tag):
            if tag not in tags:
                raise OSError(f"'{path}': missing TIFF tag {tag} (windowed reads need the "
                              f"StreamingRasterWriter layout).")
            ttype, count, val = tags[tag]
            size = {2: 1, 3: 2, 4: 4, 12: 8, 16: 8}[ttype] * count
            fmt = {2: "B", 3: "H", 4: "I", 12: "d", 16: "Q"}[ttype]
            if size <= inline_cap:
                raw = val[:size]
            else:
                (off,) = _struct.unpack("<Q" if big else "<I", val)
                pos = f.tell()
                f.seek(off)
                raw = f.read(size)
                f.seek(pos)
            return _struct.unpack(f"<{count}{fmt}", raw)

        w = _values(256)[0]
        h = _values(257)[0]
        comp = _values(259)[0] if 259 in tags else 1
        if comp != 1 or _values(339)[0] != 3 or _values(258)[0] != 32:
            raise OSError(f"'{path}': windowed reads need an uncompressed float32 TIFF.")
        # Uncompressed pixels cannot exceed the file size; a corrupt header claiming huge
        # dimensions must fail here rather than OOM on allocation.
        if h * w * 4 > os.fstat(f.fileno()).st_size:
            raise OSError(f"'{path}': implausible dimensions {h}x{w} for the file size.")
        rps = _values(278)[0]
        strip_offsets = _values(273)
        nodata = None
        if 42113 in tags:
            try:
                nodata = float(bytes(_values(42113)).rstrip(b"\x00").decode())
            except ValueError:
                pass
        row0 = max(0, row0)
        nrows = min(nrows, h - row0)
        out = np.empty((nrows, w), dtype=np.float32)
        r = row0
        while r < row0 + nrows:
            s = r // rps
            s_r0 = s * rps
            k0 = r - s_r0
            k1 = min(rps, h - s_r0, row0 + nrows - s_r0)
            f.seek(strip_offsets[s] + k0 * w * 4)
            raw = np.frombuffer(f.read((k1 - k0) * w * 4), dtype="<f4").reshape(-1, w)
            out[r - row0: r - row0 + (k1 - k0)] = raw
            r = s_r0 + k1
    if nodata is not None:
        out = np.where(out == np.float32(nodata), np.nan, out)
    return out
