"""The port's copy of the JAX package's knobs that pick the arithmetic
(``CTPU_*`` environment variables, its ``ops/knobs.py``), read once at import.

  * ``INT8_BLOCK`` (``CTPU_INT8_BLOCK``, default ``xla-plain``): how a
    dynamic-int8 block runs — ``xla-plain`` the generic block, ``xla`` with
    K1's int8 ``quant_out`` epilogue, ``hybrid`` with K6's ln/activation +
    quantize passes as well (``models/vit._int8_block_mode``).
  * ``FUSED_QMATMUL`` (``CTPU_FUSED_QMATMUL=1``): every dynamic ``q_matmul``
    runs K9, the fused quantize + int8 GEMM + dequant
    (``ops/quant.q_matmul``).
  * ``INT8_WIRE`` (``CTPU_INT8_WIRE``: ``1`` → ``on``, ``0`` → ``off``,
    anything else → ``auto``): whether int8_static takes the int8 attention
    wire (K3) — ``auto`` per tower by the JAX package's rule, ``on`` for every
    tower whose shape the wire kernel's gate takes
    (``models/vit.int8_wire_enabled`` and ``block_route``).
  * ``LN_KERNEL`` (``CTPU_LN_KERNEL``, default ``1``): ``0`` sends the
    int8_static blocks that would run K2's layernorm + static quantize to the
    generic block with static scales, whose layernorm output rounds to bf16
    before the quantize (``models/vit.block_route``).

Each of these changes which arithmetic a block runs, so each changes the
embeddings. The JAX package's other knobs pick TPU schedules of the same
arithmetic and have no counterpart here. Set a variable before the import,
or call :func:`reload` after changing it.
"""
from __future__ import annotations

import os


def reload() -> None:
    """Re-read every knob from the environment."""
    g = globals()
    g["INT8_BLOCK"] = os.environ.get("CTPU_INT8_BLOCK", "xla-plain")
    g["FUSED_QMATMUL"] = os.environ.get("CTPU_FUSED_QMATMUL") == "1"
    g["INT8_WIRE"] = {"1": "on", "0": "off"}.get(os.environ.get("CTPU_INT8_WIRE", ""), "auto")
    g["LN_KERNEL"] = os.environ.get("CTPU_LN_KERNEL", "1") == "1"


INT8_BLOCK: str
FUSED_QMATMUL: bool
INT8_WIRE: str
LN_KERNEL: bool

reload()
