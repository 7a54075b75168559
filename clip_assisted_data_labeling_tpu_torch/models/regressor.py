"""The SimpleFC label regressor (port of the JAX package's
``models/regressor.py``; the checkpoints are the same files).

The network is the reference's ``utils/nn_model.SimpleFC``: ``nn.Linear``
layers with LeakyReLU(0.01) and dropout between them, and a sigmoid head
(regression on labels scaled to [0, 1]) or a linear one (class logits, whose
softmax-expected label value is the score). ``RegressorMeta`` records the
feature recipe (CLIP models, crops, image stats) and the label bounds.

Checkpoints:
  * ``.npz``: ``__meta__`` (the meta's JSON) and ``layer{i}/kernel`` in the
    JAX package's ``[in, out]`` layout with ``layer{i}/bias``; the kernels
    are transposed to ``nn.Linear``'s ``[out, in]`` on load and back on save;
  * the reference's whole-module torch pickle, read and written through a
    ``utils.nn_model`` shim, so a pickle either package writes loads in the
    other and in the reference's own environment.

``predict`` sends features to the device in float32 (exact), float16 (the
predict stage's default; a batch over 6e4 or holding a NaN goes as float32)
or int8 (per-row scales; a batch with a non-finite value goes as float32),
upcasts them there and runs the network in float32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_assisted_data_labeling_tpu_torch.ops.similarity import quantize_rows_int8
from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device

LEAKY_SLOPE = 0.01  # torch nn.LeakyReLU's default
WIRES = ("float32", "float16", "int8")


@dataclasses.dataclass
class RegressorMeta:
    clip_models: tuple
    crop_names: tuple
    input_size: int
    hidden_sizes: tuple
    output_size: int = 1
    use_img_stat_features: bool = False
    dropout_prob: float = 0.0
    data_min: float | None = None
    data_max: float | None = None
    # classification: the sorted distinct label values seen in training; the
    # network ends in one logit each and the score is the softmax-expected
    # label value. None = regression (sigmoid head).
    class_values: tuple | None = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "RegressorMeta":
        d = json.loads(s)
        d["clip_models"] = tuple(d["clip_models"])
        d["crop_names"] = tuple(d["crop_names"])
        d["hidden_sizes"] = tuple(d["hidden_sizes"])
        if d.get("class_values") is not None:
            d["class_values"] = tuple(d["class_values"])
        return cls(**d)


class SimpleFC(nn.Module):
    """Linear layers with LeakyReLU and dropout between them; ``forward``
    ends in a sigmoid or, with ``head="linear"``, in the logits."""

    def __init__(self, input_size: int, hidden_sizes: Sequence[int], output_size: int = 1,
                 dropout_prob: float = 0.0):
        super().__init__()
        sizes = [input_size, *hidden_sizes, output_size]
        self.linears = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.dropout_prob = float(dropout_prob)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """``nn.Linear``'s default distribution, U(±1/√fan_in) for weight
        and bias, drawn layer by layer from ``gen`` (a CPU generator, so
        every device starts from the same weights)."""
        for lin in self.linears:
            bound = 1.0 / np.sqrt(lin.in_features)
            for p in (lin.weight, lin.bias):
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))

    def forward(self, x: torch.Tensor, gen: torch.Generator | None = None,
                head: str = "sigmoid") -> torch.Tensor:
        """Dropout runs only with a generator ``gen`` (on x's device): a
        mask drawn by ``torch.bernoulli`` with keep probability 1 − p, the
        kept values scaled by 1/(1 − p)."""
        p = self.dropout_prob
        last = len(self.linears) - 1
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if i < last:
                x = F.leaky_relu(x, LEAKY_SLOPE)
                if gen is not None and p > 0.0:
                    keep = torch.bernoulli(torch.full_like(x, 1.0 - p), generator=gen)
                    x = torch.where(keep.bool(), x / (1.0 - p), 0.0)
        return x if head == "linear" else torch.sigmoid(x)


class SimpleFCRegressor:
    """A ``SimpleFC`` on a device with its ``RegressorMeta``: checkpoints,
    the layout listing and batched prediction."""

    def __init__(self, net: SimpleFC, meta: RegressorMeta):
        self.net = net
        self.meta = meta

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    @classmethod
    def create(cls, meta: RegressorMeta, seed: int,
               device: str | torch.device = "cuda") -> "SimpleFCRegressor":
        """A fresh network, initialized from a CPU generator seeded by
        ``seed``."""
        device = resolve_device(device)
        net = SimpleFC(meta.input_size, meta.hidden_sizes, meta.output_size, meta.dropout_prob)
        net.reset_parameters(torch.Generator().manual_seed(seed))
        return cls(net.to(device), meta)

    def params(self) -> list[dict]:
        """The weights in the JAX package's layout: one ``{"kernel": [in,
        out], "bias": [out]}`` dict of float32 numpy arrays a layer."""
        return [{"kernel": lin.weight.detach().cpu().numpy().T.copy(),
                 "bias": lin.bias.detach().cpu().numpy().copy()}
                for lin in self.net.linears]

    def describe(self) -> str:
        """The network's layout, as the JAX package prints it for
        ``--print_network_layout``."""
        m = self.meta
        sizes = [m.input_size, *m.hidden_sizes, m.output_size]
        lines = ["SimpleFCRegressor("]
        for i in range(len(sizes) - 1):
            lines.append(f"  Linear(in_features={sizes[i]}, out_features={sizes[i + 1]})")
            if i < len(sizes) - 2:
                lines.append(f"  LeakyReLU(negative_slope={LEAKY_SLOPE})")
                lines.append(f"  Dropout(p={m.dropout_prob})")
        if m.class_values is not None:
            lines.append(f"  Softmax(classes={list(m.class_values)})")
        else:
            lines.append("  Sigmoid()")
        lines.append(")")
        n_params = sum(p.numel() for p in self.net.parameters())
        lines.append(
            f"clip_models={list(m.clip_models)} crop_names={list(m.crop_names)} "
            f"img_stats={m.use_img_stat_features} params={n_params:,}"
        )
        return "\n".join(lines)

    # --- prediction -----------------------------------------------------------
    def _to_device(self, x_host: np.ndarray, wire: str) -> torch.Tensor:
        """One batch on the device as float32, sent in the ``wire``'s format."""
        dev = self.device
        q8 = quantize_feature_rows(x_host) if wire == "int8" else None
        if q8 is not None:
            xq, scale = (torch.from_numpy(a).to(dev) for a in q8)
            return xq.float() * scale
        # the comparison is False for NaN: a NaN batch takes the exact wire
        if wire == "float16" and np.abs(x_host).max(initial=0.0) <= 6.0e4:
            return torch.from_numpy(x_host.astype(np.float16)).to(dev).float()
        return torch.from_numpy(x_host).to(dev)

    @torch.no_grad()
    def _scores(self, x: torch.Tensor) -> torch.Tensor:
        cvals = self.meta.class_values
        if cvals is None:
            return self.net(x)[:, 0]
        probs = torch.softmax(self.net(x, head="linear"), dim=-1)
        return probs @ torch.tensor(cvals, dtype=torch.float32, device=x.device)

    def predict(self, features: np.ndarray, batch_size: int = 65536,
                wire: str = "float32") -> np.ndarray:
        """Scores [N] float32 in batches of ``batch_size`` rows (the chunk
        only bounds device memory). ``wire``: float32 (exact), float16 or
        int8 (see the module's docstring); any other value raises."""
        if wire not in WIRES:
            raise ValueError(f"unknown wire {wire!r} (one of {', '.join(WIRES)})")
        if len(features) == 0:
            return np.zeros((0,), np.float32)
        outs = []
        for i in range(0, len(features), batch_size):
            x_host = np.asarray(features[i: i + batch_size], np.float32)
            outs.append(self._scores(self._to_device(x_host, wire)).cpu().numpy())
        return np.concatenate(outs)

    @torch.no_grad()
    def predict_classes(self, features: np.ndarray, batch_size: int = 65536) -> np.ndarray:
        """Classification models only: the argmax class's label value [N]."""
        if self.meta.class_values is None:
            raise ValueError("predict_classes requires a classification model")
        cvals = np.asarray(self.meta.class_values, np.float32)
        outs = []
        for i in range(0, len(features), batch_size):
            x = torch.from_numpy(np.asarray(features[i: i + batch_size], np.float32))
            logits = self.net(x.to(self.device), head="linear")
            outs.append(cvals[logits.argmax(dim=-1).cpu().numpy()])
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)

    # --- native checkpoint format ---------------------------------------------
    def save(self, path: str) -> None:
        flat = {"__meta__": np.array(self.meta.to_json())}
        for i, layer in enumerate(self.params()):
            flat[f"layer{i}/kernel"] = layer["kernel"]
            flat[f"layer{i}/bias"] = layer["bias"]
        np.savez(path, **flat)

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> "SimpleFCRegressor":
        with np.load(path, allow_pickle=False) as data:
            meta = RegressorMeta.from_json(str(data["__meta__"]))
            params = []
            while f"layer{len(params)}/kernel" in data.files:
                i = len(params)
                params.append({"kernel": data[f"layer{i}/kernel"],
                               "bias": data[f"layer{i}/bias"]})
        return regressor_from_params(params, meta, device)

    # --- reference torch-pickle interop ----------------------------------------
    @classmethod
    def load_torch_pickle(cls, path: str,
                          device: str | torch.device = "cuda") -> "SimpleFCRegressor":
        """Read the reference's whole-module pickle (or one either package
        wrote): its class path ``utils.nn_model.SimpleFC`` resolves to the
        shim, and the Linear weights and the feature recipe are read off."""
        _install_nn_model_shim()
        module = torch.load(path, map_location="cpu", weights_only=False)
        linears = [m for m in module.layers if isinstance(m, nn.Linear)]
        params = [{"kernel": lin.weight.detach().numpy().T, "bias": lin.bias.detach().numpy()}
                  for lin in linears]
        meta = RegressorMeta(
            clip_models=tuple(getattr(module, "clip_models", ())),
            crop_names=tuple(getattr(module, "crop_names", ())),
            input_size=int(linears[0].weight.shape[1]),
            hidden_sizes=tuple(int(lin.weight.shape[0]) for lin in linears[:-1]),
            output_size=int(linears[-1].weight.shape[0]),
            use_img_stat_features=bool(getattr(module, "use_img_stat_features", False)),
            data_min=_maybe_float(getattr(module, "data_min", None)),
            data_max=_maybe_float(getattr(module, "data_max", None)),
        )
        return regressor_from_params(params, meta, device)

    def save_torch_pickle(self, path: str) -> None:
        """Write the reference's whole-module pickle: ``utils.nn_model.
        SimpleFC`` with Linear + LeakyReLU + Dropout per hidden layer, the
        last Linear and a Sigmoid, and the feature-recipe attributes its
        predictor reads. Regression only: the reference reads one sigmoid
        score, and a classification head's logits would be misread."""
        if self.meta.class_values is not None:
            raise ValueError(
                "torch export is regression-only: the reference's SimpleFC "
                "(utils/nn_model.py:6-41) ends in Sigmoid and its predictor "
                "treats the output as one score — a C-logit classification "
                "head would be silently misread there"
            )
        shim = _install_nn_model_shim()
        m = self.meta
        mod = shim.SimpleFC()
        mod.clip_models = list(m.clip_models)
        mod.crop_names = list(m.crop_names)
        mod.use_img_stat_features = m.use_img_stat_features
        mod.data_min, mod.data_max = m.data_min, m.data_max
        layers = []
        n = len(self.net.linears)
        for i, lin in enumerate(self.net.linears):
            out = nn.Linear(lin.in_features, lin.out_features)
            with torch.no_grad():
                out.weight.copy_(lin.weight.detach().cpu())
                out.bias.copy_(lin.bias.detach().cpu())
            layers.append(out)
            if i < n - 1:
                layers.append(nn.LeakyReLU())
                layers.append(nn.Dropout(p=m.dropout_prob))
        layers.append(nn.Sigmoid())
        mod.layers = nn.ModuleList(layers)
        mod.eval()
        torch.save(mod, path)


def regressor_from_params(params: list[dict], meta: RegressorMeta,
                          device: str | torch.device = "cuda") -> SimpleFCRegressor:
    """The port's regressor from weights in the JAX package's layout (a
    ``{"kernel": [in, out], "bias": [out]}`` dict of arrays a layer, as its
    ``SimpleFCRegressor.params`` holds them); ``meta`` gives the dropout and
    the recipe, the kernels give the widths."""
    device = resolve_device(device)
    kernels = [np.array(p["kernel"], np.float32) for p in params]
    net = SimpleFC(kernels[0].shape[0], [k.shape[1] for k in kernels[:-1]],
                   kernels[-1].shape[1], meta.dropout_prob)
    with torch.no_grad():
        for lin, k, p in zip(net.linears, kernels, params):
            lin.weight.copy_(torch.from_numpy(k.T))
            lin.bias.copy_(torch.from_numpy(np.array(p["bias"], np.float32)))
    return SimpleFCRegressor(net.to(device), meta)


def _install_nn_model_shim():
    """Register a ``utils.nn_model`` stand-in so reference module pickles can
    be read (classes resolved by name at unpickle) and written (``__module__``
    and ``__qualname__`` pinned, so torch.save names
    ``utils.nn_model.SimpleFC``, the real class in the reference's
    environment). A shim already registered (the JAX package installs the
    same one) is reused. Returns the shim module."""
    import sys
    import types

    if "utils.nn_model" not in sys.modules:
        shim_pkg = sys.modules.setdefault("utils", types.ModuleType("utils"))
        shim = types.ModuleType("utils.nn_model")

        class SimpleFC(nn.Module):  # populated by (un)pickling
            def forward(self, x):  # the reference's forward
                for layer in self.layers:
                    x = layer(x)
                return x

        class SimpleconvFC(nn.Module):
            pass

        for klass in (SimpleFC, SimpleconvFC):
            klass.__module__ = "utils.nn_model"
            klass.__qualname__ = klass.__name__
        shim.SimpleFC = SimpleFC
        shim.SimpleconvFC = SimpleconvFC
        shim.device = torch.device("cpu")
        sys.modules["utils.nn_model"] = shim
        shim_pkg.nn_model = shim
    return sys.modules["utils.nn_model"]


def _maybe_float(x):
    if x is None:
        return None
    try:
        return float(x)
    except (TypeError, ValueError):
        return None


def quantize_feature_rows(x_host: np.ndarray):
    """The int8 wire: per-row symmetric int8 (``ops/similarity.
    quantize_rows_int8``, the dedup wire's quantizer) → (int8 [N, F], float32
    scales [N, 1]), or None when the batch holds a non-finite value (the
    caller then sends float32)."""
    if not np.isfinite(x_host).all():
        return None
    xq, scale = quantize_rows_int8(x_host)
    return xq, scale[:, None]
