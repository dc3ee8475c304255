"""Seeded ``torch.Generator`` streams.

Counterpart of ``phendiff_tpu/core/rng.py``.  ``jax.random`` keys become
generators: ``KeyStream(seed).next()`` hands out a fresh generator whose
seed is derived from the root seed and the draw index, so a stream is
reproducible from its seed alone.  torch and ``jax.random`` give different
numbers from the same seed; tests that compare the two packages inject the
same numpy noise into both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Fixed evaluation seed, numerically identical to the reference's
# (utils_training.py:698) so eval sampling is reproducible across runs.
EVAL_SEED = 5742877512


def derive_seed(*words: int) -> int:
    """A 63-bit seed from a tuple of non-negative integers (SeedSequence
    hashing: distinct tuples give independent seeds)."""
    state = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    return int((int(state[0]) << 32 | int(state[1])) & (2**63 - 1))


class KeyStream:
    """A mutable stream of generators: ``stream.next()`` returns a new one."""

    def __init__(self, seed: int):
        if seed < 0:
            raise ValueError("seed must be non-negative")
        self._seed = int(seed)
        self._count = 0

    def next(self) -> torch.Generator:
        self._count += 1
        return self.fold_in(self._count)

    def fold_in(self, data: int) -> torch.Generator:
        """A CPU generator determined by the root seed and ``data`` only
        (the samplers draw on the generator's device and move the noise)."""
        return torch.Generator().manual_seed(derive_seed(self._seed, int(data)))


@dataclasses.dataclass(frozen=True)
class RowsOf:
    """A generator standing for rows ``rows`` of a batch of ``batch`` rows:
    the samplers draw each noise tensor for the whole batch from
    ``generator`` and keep those rows.  Under data parallelism a process
    computes its share of a batch with it, and gets the numbers the whole
    batch would have had in one process."""

    generator: torch.Generator
    batch: int
    rows: torch.Tensor  # int64 indices into the batch

    @property
    def device(self) -> torch.device:
        return self.generator.device
