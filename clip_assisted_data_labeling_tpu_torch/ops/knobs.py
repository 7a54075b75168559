"""The port's copy of the JAX package's dynamic-int8 knobs (``CTPU_*``
environment variables, its ``ops/knobs.py``), read once at import.

  * ``INT8_BLOCK`` (``CTPU_INT8_BLOCK``, default ``xla-plain``): how a
    dynamic-int8 block runs — ``xla-plain`` the generic block, ``xla`` with
    K1's int8 ``quant_out`` epilogue, ``hybrid`` with K6's ln/activation +
    quantize passes as well (``models/vit._int8_block_mode``).
  * ``FUSED_QMATMUL`` (``CTPU_FUSED_QMATMUL=1``): every dynamic ``q_matmul``
    runs K9, the fused quantize + int8 GEMM + dequant
    (``ops/quant.q_matmul``).

The JAX package's other knobs select TPU schedules and have no counterpart
here. Set a variable before the import, or call :func:`reload` after
changing it.
"""
from __future__ import annotations

import os


def reload() -> None:
    """Re-read every knob from the environment."""
    g = globals()
    g["INT8_BLOCK"] = os.environ.get("CTPU_INT8_BLOCK", "xla-plain")
    g["FUSED_QMATMUL"] = os.environ.get("CTPU_FUSED_QMATMUL") == "1"


INT8_BLOCK: str
FUSED_QMATMUL: bool

reload()
