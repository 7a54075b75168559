"""clip_assisted_data_labeling_tpu_torch — the PyTorch/CUDA port of
``clip_assisted_data_labeling_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module paths so
each module's counterpart is easy to find, and shares its on-disk formats
(``.pt`` sidecars, the columnar store, ``.npz`` weights, ``.calib.npz``
calibration files) so either package reads what the other wrote.

It imports torch and numpy only — never jax, and nothing from the JAX package.

Ported so far: stages 1 (embed), 2 (dedup), 4 (train), 5 (predict, and the
single-image scorer) and 6 (subset).
  store/     sidecar features, the columnar store and the label CSV
  ops/       crops, image stats, quantization, similarity, and the hand-written
             CUDA kernels in csrc/
  models/    the ViT image towers, weight carry-over, the encoder, the FC
             regressor and the single-image scorer
  data/      host-side image decode, bucketed batching, image-header sizes
  pipeline/  the stage CLIs (``python -m clip_assisted_data_labeling_tpu_torch.pipeline.<stage>``:
             embed, dedup, train, predict, predict_simple, subset)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(CLI: ``--device cpu``); asking for the card where there is none raises.
"""

__version__ = "0.1.0"
