"""Deterministic seeding (reference: utilities/random_seed.py:5-10).

Port of `vehicle_counting_tpu/utils/seed.py`, with torch's own generators
(CPU and every card) seeded too.
"""

from __future__ import annotations

import random

import numpy as np


def seed_everything(seed: int = 1702) -> None:
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
