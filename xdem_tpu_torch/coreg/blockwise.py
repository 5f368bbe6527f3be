"""Blockwise coregistration: not ported yet.

xdem_tpu's BlockwiseCoreg and BlockwiseNuthKaab take ``Raster`` inputs (their tiles carry
their own georeferencing), and the port has no ``Raster`` yet. The names exist so that code
written against xdem_tpu fails with a clear message instead of an AttributeError.
"""

from __future__ import annotations

from typing import Any


class _NeedsRaster:
    def __init__(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(
            f"{type(self).__name__} takes Raster inputs, and Raster is not ported to xdem_tpu_torch yet; "
            "fit a single affine method (NuthKaab, DhMinimize, ICP, CPD, LZD) on the whole grid instead."
        )


class BlockwiseCoreg(_NeedsRaster):
    """Not ported: needs Raster."""


class BlockwiseNuthKaab(_NeedsRaster):
    """Not ported: needs Raster."""


class MultiprocConfig(_NeedsRaster):
    """Not ported: needs Raster."""
