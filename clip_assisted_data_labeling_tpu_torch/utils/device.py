"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for ``cpu``; asking
for the card where there is none raises — there is no silent fall back to the
CPU. TF32 is switched off for both matmuls and cuDNN so float32 runs keep full
float32 precision (the parity paths compare against float32 references).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
