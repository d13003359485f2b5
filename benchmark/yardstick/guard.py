"""The JAX package and JAX itself stay out of every benchmark process."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "gol_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden
    (`gol_tpu_torch` is not `gol_tpu`)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))
