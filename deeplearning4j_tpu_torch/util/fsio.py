"""Small filesystem primitives shared across subsystems.

A copy of the JAX package's stdlib-only ``util/fsio.py``.
"""

from __future__ import annotations

import os


def atomic_write_text(path: str, text: str, *, fsync: bool = False) -> None:
    """Write ``text`` to ``path`` atomically (tmp file + ``os.replace``).

    ``fsync=True`` additionally flushes the tmp file to disk before the
    replace — the journaling callers (pipeline state) pay it; the
    high-frequency callers (elastic heartbeats/stamps) do not.
    """
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(text)
        if fsync:
            fh.flush()
            os.fsync(fh.fileno())
    os.replace(tmp, path)
