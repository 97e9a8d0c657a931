"""
Random-number-generator plumbing.

The reference spawns per-MPI-rank generators from a SeedSequence
(gpry/mpi.py:31-50).  Single-controller equivalent: one numpy Generator for
host-side decisions, plus explicit ``torch.Generator``s seeded from it for
device draws.
"""

import numpy as np
import torch


def get_random_generator(seed=None):
    """Build the host Generator (reference: gpry/mpi.py:31)."""
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


def torch_generator_from_rng(rng, device):
    """A ``torch.Generator`` on ``device`` seeded from the host generator.

    Draws what the JAX package draws for its PRNG key at the same site
    (``int(rng.integers(2**31))``), so that the host stream stays aligned
    with gpry_tpu's for every later numpy draw."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2**31)))
    return gen
