"""Seeded random subsamples on the device of their mask.

Every draw takes an explicit ``torch.Generator`` on the mask's device. Torch and JAX give
other bits from one seed, so a subsample agrees with xdem_tpu's in its statistics, not in
its indices; tests that need xdem_tpu's exact picks inject them.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch


def seed_from(random_state: Any) -> int:
    """An int seed: the random_state itself, or a draw from it (None or a numpy Generator)."""
    if isinstance(random_state, (int, np.integer)):
        return int(random_state)
    return int(np.random.default_rng(random_state).integers(2**31))


def topk_subsample(generator: torch.Generator, valid_flat: torch.Tensor, count: int):
    """Seeded fixed-size subsample without replacement: uniform scores with invalid slots
    parked at -inf, then top-k along the last axis (a leading axis draws one subsample per
    row from the one generator). Returns (indices, picked_valid); when count exceeds the
    valid population the overflow picks have picked_valid=False and must be NaN-poisoned."""
    u = torch.rand(valid_flat.shape, generator=generator, device=valid_flat.device)
    scores = torch.where(valid_flat, u, -math.inf)
    idx = torch.topk(scores, count, sorted=False).indices
    return idx, torch.gather(valid_flat, -1, idx)
