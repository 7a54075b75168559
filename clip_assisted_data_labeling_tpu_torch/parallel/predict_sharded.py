"""Data-parallel regressor inference over the device mesh (port of the JAX
package's ``parallel/predict_sharded.py``).

The [N, F] feature matrix is split on its leading axis over the 1-D ``data``
mesh, the small network is replicated (one copy per distinct device), and
each shard runs the port's regressor forward (``models/regressor.SimpleFC``)
with no collective; the scores come back to the host and are concatenated.
"""
from __future__ import annotations

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.models.regressor import (
    WIRES,
    SimpleFC,
    quantize_feature_rows,
)
from clip_assisted_data_labeling_tpu_torch.parallel.mesh import Mesh


def net_from_params(params: list[dict], device: torch.device) -> SimpleFC:
    """The regressor network from the JAX layout's ``{"kernel": [in, out],
    "bias": [out]}`` layers, on ``device``."""
    kernels = [np.array(p["kernel"], np.float32) for p in params]
    net = SimpleFC(kernels[0].shape[0], [k.shape[1] for k in kernels[:-1]], kernels[-1].shape[1])
    with torch.no_grad():
        for lin, k, p in zip(net.linears, kernels, params):
            lin.weight.copy_(torch.from_numpy(k.T))
            lin.bias.copy_(torch.from_numpy(np.array(p["bias"], np.float32)))
    return net.to(device)


@torch.no_grad()
def _forward(net: SimpleFC, x: torch.Tensor, scale: torch.Tensor | None,
             cvals: torch.Tensor | None) -> torch.Tensor:
    """One shard: upcast on the device (the int8 wire times its row scales),
    then the sigmoid head, or the softmax-expected class value."""
    x32 = x.to(torch.float32)
    if scale is not None:
        x32 = x32 * scale
    if cvals is not None:
        return torch.softmax(net(x32, head="linear"), dim=-1) @ cvals
    return net(x32)[:, 0]


def predict_sharded(
    params: list[dict],
    features: np.ndarray,
    mesh: Mesh,
    batch_size: int = 65536,
    wire: str = "float16",
    class_values=None,  # classification models: meta.class_values
) -> np.ndarray:
    """Scores [N] for ``features`` [N, F], split over the mesh's devices.

    ``params`` is the regressor's layer list (``SimpleFCRegressor.params()``).
    Any N: each chunk (a multiple of the mesh size) is zero-padded to split
    evenly and the pad rows are sliced off. ``wire`` as
    ``SimpleFCRegressor.predict``: float16 (a chunk over 6.0e4 goes as
    float32), int8 (per-row scales, split with the rows) or float32.
    """
    if wire not in WIRES:
        raise ValueError(f"wire must be 'float16', 'float32' or 'int8', got {wire!r}")
    devs = list(mesh.devices.flat)
    n_dev = len(devs)
    nets: dict[torch.device, SimpleFC] = {}
    cv: dict[torch.device, torch.Tensor | None] = {}
    for d in devs:
        if d not in nets:
            nets[d] = net_from_params(params, d)
            cv[d] = (None if class_values is None
                     else torch.tensor(class_values, dtype=torch.float32, device=d))
    chunk = max(n_dev, (batch_size // n_dev) * n_dev)
    outs = []
    for i in range(0, len(features), chunk):
        x_host = np.asarray(features[i: i + chunk], np.float32)
        pad = (-len(x_host)) % n_dev
        if pad:
            x_host = np.pad(x_host, [(0, pad), (0, 0)])
        q8 = quantize_feature_rows(x_host) if wire == "int8" else None
        scale_host = None
        if q8 is not None:
            x_host, scale_host = q8
        elif wire == "float16" and np.abs(x_host).max(initial=0.0) <= 6.0e4:
            x_host = x_host.astype(np.float16)
        m = len(x_host) // n_dev
        parts = []
        for s, d in enumerate(devs):
            x = torch.from_numpy(x_host[s * m: (s + 1) * m]).to(d)
            scale = None if scale_host is None else torch.from_numpy(
                scale_host[s * m: (s + 1) * m]).to(d)
            parts.append(_forward(nets[d], x, scale, cv[d]))
        out = torch.cat([p.cpu() for p in parts]).numpy()
        outs.append(out[: len(out) - pad] if pad else out)
    if not outs:
        return np.zeros((0,), np.float32)
    return np.concatenate(outs, axis=0)
