"""clip_assisted_data_labeling_tpu_torch — the PyTorch/CUDA port of
``clip_assisted_data_labeling_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module paths so
each module's counterpart is easy to find, and shares its on-disk formats
(``.pt`` sidecars, the columnar store, ``.npz`` weights, ``.calib.npz``
calibration files) so either package reads what the other wrote.

It imports torch and numpy only — never jax, and nothing from the JAX package.

Ported: all seven stages — 0 (prep), 1 (embed), 2 (dedup), 3 (label), 4
(train), 5 (predict, and the single-image scorer) and 6 (subset) — the
active-learning loop and the store CLI; ``python -m
clip_assisted_data_labeling_tpu_torch`` prints the stage map.
  store/     sidecar features, the columnar store and the label CSV
  ops/       crops, image stats, quantization, similarity, the farthest-point
             order, and the hand-written CUDA kernels in csrc/
  models/    the ViT image towers (CLIP, SigLIP, naflex, PE, EVA, CoCa,
             CLIPA), weight carry-over, the encoder, the FC regressor and the
             single-image scorer
  data/      host-side image decode (the native JPEG decoder, cv2, PIL, PNG),
             bucketed batching, image-header sizes
  ui/        the labelling backends (opencv, headless, oracle) and sort orders
  pipeline/  the stage CLIs (``python -m clip_assisted_data_labeling_tpu_torch.pipeline.<stage>``:
             prep, embed, dedup, label, train, predict, predict_simple, subset,
             loop, store)
  parallel/  the device mesh, data-parallel embed and predict, the ring dedup,
             tensor parallelism
  tools/     similarity search, SVM ranking, the prompt-latent regressor,
             dataset merge, subset, quarantine, the sidecar dump
  dryrun.py  the flagship embed step and the multi-device dry run

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(CLI: ``--device cpu``); asking for the card where there is none raises.
"""

__version__ = "0.1.0"
