"""Naming helpers: uuid assignment and natural ("nautilus") sort (port of the
JAX package's ``utils/naming.py``, the same keys and the same uuid format).

The reference depends on natsort for case-insensitive natural ordering; this
is a dependency-free equivalent.
"""
from __future__ import annotations

import re
import uuid as _uuid

_SPLIT = re.compile(r"(\d+)")


def _natural_key(s: str):
    # isdecimal, not isdigit: only decimal digits parse with int(); isdigit is
    # also True for characters such as '²' that \d never captures
    return tuple(
        int(part) if part.isdecimal() else part.casefold()
        for part in _SPLIT.split(s)
    )


def natural_sort(names: list[str]) -> list[str]:
    """Case-insensitive natural sort (digit runs compare numerically)."""
    return sorted(names, key=_natural_key)


def new_uuid() -> str:
    """uuid4 hex string, the reference's file identifier."""
    return _uuid.uuid4().hex
