"""Defensive environment-variable parsing (a copy of
`gol_tpu/utils/envcfg.py`) for the engine's chunk settings and the
controller's event cap: garbage or negative values degrade to the
documented default instead of aborting a run with ValueError."""

from __future__ import annotations

import os


def env_float(name: str, default: float) -> float:
    """Non-negative float env var, `default` on garbage or negatives."""
    try:
        v = float(os.environ.get(name, default))
    except ValueError:
        return default
    return v if v >= 0 else default


def env_int(name: str, default: int, minimum: int = 1) -> int:
    """Int env var clamped to `minimum`, `default` on garbage."""
    try:
        v = int(os.environ.get(name, default))
    except ValueError:
        return default
    return max(v, minimum)
