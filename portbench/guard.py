"""The JAX guard: a run of the port's benchmark may not load JAX, Flax or the
JAX package. Names are compared by their top-level part (before the first
dot) whole, so the port's package, whose name begins with the JAX package's,
passes."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "clip_assisted_data_labeling_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
