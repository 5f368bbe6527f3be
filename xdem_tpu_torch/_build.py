"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` file of the package, one process per file, all started
together (so a build takes its slowest file's time, not the sum), and links the objects into
one shared library with a plain C interface (no PyTorch headers, so it builds in seconds),
under ``xdem_tpu_torch/_build/<hash of sources, generated headers and flags>/``; ``ctypes``
loads it. The build runs at first use, never at import: the package imports on machines
without ``nvcc``.

The kernels' tables are typed once, in Python, and reach the sources through two headers
that are written into the build directory before ``nvcc`` runs. ``surface_fit_header()``
writes the stencil tables of K1 from ``terrain/surfit.py`` as ``surface_fit_tables.h``
(flipped taps, non-zero ones only, as preprocessor lists), which ``csrc/surface_fit.cu``
includes. ``windowed_header()`` writes the attribute codes and the Jenness rugosity geometry
of K2 from ``terrain/window.py`` as ``windowed_tables.h`` (each of the 16 half-lengths as one
of four segment planes at an offset, and the eight triangles), which ``csrc/windowed.cu``
includes.

Each exported ``launch_*`` function takes device pointers, host pointers to small parameter
tables and a CUDA stream, launches on that stream, allocates nothing and returns
``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libxdem_tpu_torch_kernels.so"

# -fmad=false: each multiply and add rounds on its own, as the unfused elementwise ops of the
# plain PyTorch versions do, so kernel and plain version agree to the last bits of a sum.
# With nvcc's default contraction K1 departs from its plain version on an H100 by up to 9.6x
# the mean magnitude in the Florinsky curvatures (and 2.4e-3 in aspect) at near-flat pixels,
# far outside the 1e-3 terrain tolerance; K2 and K3 stay within it either way.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argtypes of every exported function: pointers and the stream as c_void_p (a c_int would
# cut a 64-bit pointer), scalars as c_int / c_float.
SIGNATURES = {
    "launch_surface_fit": (_P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _F, _F, _F, _F, _P),
    "launch_windowed": (_P, _P, _I, _I, _I, _I, _I, _P, _F, _P),
    "launch_fractal": (_P, _P, _I, _I, _I, _I, _P, _P, _F, _F, _P),
    "fractal_max_shared_window": (),
    "windowed_max_shared_window": (),
}


TABLES_HEADER = "surface_fit_tables.h"
WINDOWED_HEADER = "windowed_tables.h"


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def surface_fit_header() -> str:
    """Text of ``surface_fit_tables.h``, generated from the tables of ``terrain/surfit.py``.

    Per attribute ``XDT_ATTR_<NAME>`` is its code (its place in ``SURFACE_FIT_ATTRS``); per
    fit ``XDT_FIT_<NAME>`` is its id (its place in ``_FIT_DERIVS``). ``XDT_SURFIT_FITS(F)``
    lists ``F(id, window size, number of derivative roles)``. Per fit and role
    ``XDT_TAPS_<FIT>_<ROLE>(T)`` lists ``T(u, v, weight)`` for the non-zero taps of the flipped
    stencil in row-major order, the order in which ``surfit._apply_stencils`` adds them:
    offset (u, v) from the window's top-left corner takes ``K[k-1-u, k-1-v]``.
    ``XDT_SURFIT_STENCILS(S)`` lists ``S(fit id, role id, taps list)`` for every stencil.
    """
    from xdem_tpu_torch.terrain import surfit

    roles = tuple(surfit.DIV_POW)  # z_x, z_y, z_xx, z_yy, z_xy
    lines = ["// Generated from xdem_tpu_torch/terrain/surfit.py by xdem_tpu_torch/_build.py: do not edit.",
             "#pragma once"]
    lines += [f"#define XDT_ATTR_{a.upper()} {code}" for code, a in enumerate(surfit.SURFACE_FIT_ATTRS)]
    lines.append(f"#define XDT_N_ATTRS {len(surfit.SURFACE_FIT_ATTRS)}")
    fits, stencils = [], []
    for fit_id, (fit, derivs) in enumerate(surfit._FIT_DERIVS.items()):
        lines.append(f"#define XDT_FIT_{fit.upper()} {fit_id}")
        k = surfit.ALL_STENCILS[derivs["z_x"]].shape[0]
        fits.append(f"F({fit_id}, {k}, {len(derivs)})")
        for role_id, role in enumerate(roles):
            if role not in derivs:
                continue
            flipped = surfit.ALL_STENCILS[derivs[role]][::-1, ::-1]
            taps = " ".join(f"T({u}, {v}, {float(np.float32(flipped[u, v]))!r}f)"
                            for u in range(k) for v in range(k) if flipped[u, v] != 0)
            macro = f"XDT_TAPS_{fit.upper()}_{role.upper()}"
            lines.append(f"#define {macro}(T) {taps}")
            stencils.append(f"S({fit_id}, {role_id}, {macro})")
    lines.append("#define XDT_SURFIT_FITS(F) " + " ".join(fits))
    lines.append("#define XDT_SURFIT_STENCILS(S) " + " ".join(stencils))
    return "\n".join(lines) + "\n"


def windowed_header() -> str:
    """Text of ``windowed_tables.h``, generated from the tables of ``terrain/window.py``.

    Per attribute ``XDT_WIN_<NAME>`` is its code (its place in ``WINDOWED_ATTRS``).
    ``XDT_RUG_SEGMENTS(S)`` lists ``S(i, plane, du, dv)`` for the 16 half-lengths of the
    Jenness geometry in the order of ``RUGOSITY_CENTER_SEGS`` then ``RUGOSITY_EDGE_SEGS``:
    half-length i is the entry of `plane` at offset (du, dv) from the window's top-left
    corner, where an entry (r, c) of plane HH joins pixel (r, c) to (r, c + 1), of HV to
    (r + 1, c), of D1 to (r + 1, c + 1), and of D2 joins (r, c + 1) to (r + 1, c). Segments
    along a row or a column have the length factor 1; the diagonals share
    ``XDT_RUG_DIAG_FACTOR``, the table's factor rounded to float32.
    ``XDT_RUG_TRIANGLES(T)`` lists ``T(ia, ib, ic)``, the triangles of ``RUGOSITY_TRIS``.
    Raises ValueError for a table that does not join neighbouring pixels of a 3 x 3 window
    with these factors.
    """
    from xdem_tpu_torch.terrain import window

    lines = ["// Generated from xdem_tpu_torch/terrain/window.py by xdem_tpu_torch/_build.py: do not edit.",
             "#pragma once"]
    lines += [f"#define XDT_WIN_{a.upper()} {code}" for code, a in enumerate(window.WINDOWED_ATTRS)]
    lines.append(f"#define XDT_WIN_N_ATTRS {len(window.WINDOWED_ATTRS)}")
    ends = [((1, 1), pos, f) for pos, f in window.RUGOSITY_CENTER_SEGS]
    ends += [(p0, p1, 1.0) for p0, p1 in window.RUGOSITY_EDGE_SEGS]
    planes = {(0, 1): "HH", (1, 0): "HV", (1, 1): "D1", (1, -1): "D2"}
    segs, diag = [], set()
    for i, (p, q, factor) in enumerate(ends):
        (r0, c0), (r1, c1) = sorted((p, q))  # the upper end first
        plane = planes.get((r1 - r0, c1 - c0))
        if plane is None or not all(0 <= x <= 2 for x in (r0, c0, r1, c1)):
            raise ValueError(f"Rugosity segment {i} ({p} to {q}) does not join neighbouring pixels of a 3 x 3 window.")
        if plane.startswith("D"):
            diag.add(factor)
        elif factor != 1.0:
            raise ValueError(f"Rugosity segment {i} ({p} to {q}) runs along the grid with a length factor of {factor}, not 1.")
        segs.append(f"S({i}, {plane}, {r0}, {min(c0, c1)})")
    if len(diag) != 1:
        raise ValueError(f"The diagonal rugosity segments need one length factor, got {sorted(diag)}.")
    n = len(ends)
    for tri in window.RUGOSITY_TRIS:
        if len(tri) != 3 or not all(0 <= t < n for t in tri):
            raise ValueError(f"Rugosity triangle {tri} does not name three of the {n} half-lengths.")
    lines.append(f"#define XDT_RUG_N_SEGMENTS {n}")
    lines.append(f"#define XDT_RUG_DIAG_FACTOR {float(np.float32(diag.pop()))!r}f")
    lines.append("#define XDT_RUG_SEGMENTS(S) " + " ".join(segs))
    lines.append("#define XDT_RUG_TRIANGLES(T) " + " ".join(f"T({a}, {b}, {c})" for a, b, c in window.RUGOSITY_TRIS))
    return "\n".join(lines) + "\n"


def generated_headers() -> dict[str, str]:
    """File name -> text of every header that is written into the build directory."""
    return {TABLES_HEADER: surface_fit_header(), WINDOWED_HEADER: windowed_header()}


def find_nvcc() -> str | None:
    """nvcc from $CUDA_HOME, /usr/local/cuda, or the PATH; None when there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return shutil.which("nvcc")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    for name, text in generated_headers().items():
        digest.update(name.encode())
        digest.update(text.encode())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / digest.hexdigest()[:16] / LIB_NAME


def _run(job: tuple[str, list[str]]) -> tuple[str, list[str], str, int, float]:
    """(label, command, output, exit code, seconds) of one nvcc job."""
    label, cmd = job
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return label, cmd, proc.stdout, proc.returncode, time.perf_counter() - t0


def build() -> tuple[Path, float, str]:
    """Compile the kernels unless this exact build exists; returns (library, seconds spent
    compiling, compiler output with each job's own seconds: a source's compile, or the
    link). Raises RuntimeError without nvcc or on a failed build."""
    lib = library_path()
    if lib.is_file():
        return lib, 0.0, ""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc was not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): the "
            "CUDA kernels of xdem_tpu_torch cannot be built on this machine."
        )
    lib.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    for name, text in generated_headers().items():
        header = lib.with_name(f"{name}.{tag}")
        header.write_text(text)
        os.replace(header, lib.with_name(name))  # the same text from every process that builds this hash
    tmp = lib.with_name(f"{LIB_NAME}.{tag}")
    cus = [s for s in sources() if s.suffix == ".cu"]
    objs = [lib.with_name(f"{s.stem}.{tag}.o") for s in cus]
    cmds = {s.name: [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-I", str(lib.parent), "-c", "-o", str(o), str(s)]
            for s, o in zip(cus, objs)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cmds)) as pool:
        runs = list(pool.map(_run, cmds.items()))
    if all(rc == 0 for _, _, _, rc, _ in runs):
        runs.append(_run(("link", [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(o) for o in objs)])))
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    log = "".join(f"nvcc {label}: {secs:.2f} s\n{out}" for label, _, out, _, secs in runs)
    for _, cmd, out, rc, _ in runs:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    os.replace(tmp, lib)  # atomic: concurrent builders never load a half-written library
    return lib, seconds, log


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built at first use, with argtypes/restype set on every function."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
