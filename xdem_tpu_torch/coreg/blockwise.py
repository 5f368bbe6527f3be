"""Blockwise coregistration: not ported yet.

xdem_tpu's BlockwiseCoreg, BlockwiseNuthKaab and MultiprocConfig (xdem_tpu/coreg/blockwise.py)
have no counterpart in this package yet: ROADMAP.md lists them as the next coregistration
module to port. The names exist so that code written against xdem_tpu fails with a clear
message instead of an AttributeError.
"""

from __future__ import annotations

from typing import Any


class _NotPorted:
    def __init__(self, *args: Any, **kwargs: Any):
        raise NotImplementedError(
            f"{type(self).__name__} (xdem_tpu/coreg/blockwise.py) is not ported to xdem_tpu_torch yet; "
            "fit a single affine method (NuthKaab, DhMinimize, ICP, CPD, LZD) on the whole grid instead."
        )


class BlockwiseCoreg(_NotPorted):
    """Not ported yet."""


class BlockwiseNuthKaab(_NotPorted):
    """Not ported yet."""


class MultiprocConfig(_NotPorted):
    """Not ported yet."""
