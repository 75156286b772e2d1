"""Reproducible random seeds (reference: fbpic/utils/random_seed.py)."""
import numpy as np


def set_random_seed(seed, rank=0):
    """Seed numpy's global RNG, offset per rank/device."""
    np.random.seed(seed + rank)
