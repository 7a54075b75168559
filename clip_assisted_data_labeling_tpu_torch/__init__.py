"""clip_assisted_data_labeling_tpu_torch — the PyTorch/CUDA port of
``clip_assisted_data_labeling_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module paths so
each module's counterpart is easy to find, and shares its on-disk formats
(``.pt`` sidecars, the columnar store, ``.npz`` weights, ``.calib.npz``
calibration files) so either package reads what the other wrote.

It imports torch and numpy only — never jax, and nothing from the JAX package.

Ported so far: stage 1 (embed) for the plain CLIP ViT towers.
  store/     sidecar features and the columnar store
  ops/       crops, image stats, quantization, and the hand-written CUDA kernels
             (packed attention, layernorm + static int8 quantize) in csrc/
  models/    the CLIP ViT image tower, weight carry-over, the encoder
  data/      host-side image decode and bucketed batching
  pipeline/  the embed CLI (``python -m clip_assisted_data_labeling_tpu_torch.pipeline.embed``)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(CLI: ``--device cpu``); asking for the card where there is none raises.
"""

__version__ = "0.1.0"
