"""Seeds derived from the run's ``--seed``: every draw of a run comes from
one of these, so one seed gives the same inputs, weights and draws."""

from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by ``tags`` (any ``--seed``, also
    one beyond 32 bits)."""
    text = ":".join(str(t) for t in (int(seed), *tags))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1
