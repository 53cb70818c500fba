"""Elastic supervision — the restart budget and its backoff ladder.

Counterpart of the JAX package's ``parallel/elastic.py``. Only
:class:`BackoffPolicy` is ported so far: the batching dispatcher's
supervised restarts (``parallel/inference.py``) run on it. Its jitter is
hashed from ``(seed, attempt)`` with SHA-256 exactly as the reference's,
so both packages wait the same delays. The elastic supervisor, its
launchers and its workers come with the multi-device slice.
"""

from __future__ import annotations

import dataclasses
import hashlib


@dataclasses.dataclass
class BackoffPolicy:
    """Restart budgeting: exponential backoff with deterministic jitter.

    ``max_restarts`` is the per-slot budget of post-liveness restarts; a
    slot that exhausts it is shrunk away (or, at ``min_workers``, fails
    the job). Jitter is hashed from ``(seed, attempt)`` — reproducible,
    no RNG state, but still de-synchronizes a fleet of supervisors."""

    base_s: float = 1.0
    factor: float = 2.0
    max_s: float = 60.0
    jitter: float = 0.1
    max_restarts: int = 2

    def delay(self, attempt: int, seed: str = "") -> float:
        d = min(self.max_s, self.base_s * self.factor ** max(0, attempt - 1))
        if self.jitter:
            h = int(hashlib.sha256(f"{seed}:{attempt}".encode())
                    .hexdigest()[:8], 16)
            d *= 1.0 + self.jitter * (2.0 * (h / 0xffffffff) - 1.0)
        return d
