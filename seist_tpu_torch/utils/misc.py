"""Small helpers (the port's copy of what it needs from
``seist_tpu/utils/misc.py``)."""

from __future__ import annotations

import os


def get_safe_path(path: str) -> str:
    """Dedupe a path by appending ``_new`` recursively: a results file
    never overwrites an earlier run's."""
    if not os.path.exists(path):
        return path
    base, ext = os.path.splitext(path)
    return get_safe_path(f"{base}_new{ext}")
