"""The single-image aesthetic scorer (port of the JAX package's
``models/aesthetic.py``): a trained regressor and the CLIP encoders it was
trained with (``create_encoder``, bfloat16 by default), applied to one image
at a time through the batch pipeline's preprocess.

The image is fitted to the canvas by the loader's own code
(``data/loader.fit_to_canvas``: cv2, else PIL, else a numpy box filter) and
centred on it; the 4-crop embedding and, where the checkpoint asks for them,
the 22 image stats run on the device; the features are assembled in the
trainer's order (per model: its crops, then the stats).
"""
from __future__ import annotations

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.config import ALL_CROPS
from clip_assisted_data_labeling_tpu_torch.data.loader import fit_to_canvas
from clip_assisted_data_labeling_tpu_torch.models.encoders import create_encoder
from clip_assisted_data_labeling_tpu_torch.models.regressor import SimpleFCRegressor
from clip_assisted_data_labeling_tpu_torch.ops.crops import make_crop_params
from clip_assisted_data_labeling_tpu_torch.ops.image_stats import (
    image_stats_batch,
    make_stat_params,
)
from clip_assisted_data_labeling_tpu_torch.store.sidecar import resolve_crop_key
from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device


class AestheticRegressor:
    def __init__(self, model_path: str, model_weights_dir: str | None = None,
                 canvas_size: int = 1024, verbose: int = 1,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if model_path.endswith(".npz"):
            self.model = SimpleFCRegressor.load(model_path, self.device)
        else:
            self.model = SimpleFCRegressor.load_torch_pickle(model_path, self.device)
        if verbose:
            print("Loaded regression model")
            print("Trained on embeddings from CLIP models:", list(self.model.meta.clip_models))
            print("Used crops:", list(self.model.meta.crop_names))
        self.encoders = [
            create_encoder(name, model_path=model_weights_dir, device=self.device)
            for name in self.model.meta.clip_models
        ]
        self.canvas_size = canvas_size

    def predict_score(self, img) -> tuple[float, np.ndarray]:
        """(score, features [1, F]) for one image: an [H, W, 3] uint8 RGB
        array, or a PIL image (converted to RGB)."""
        if not isinstance(img, np.ndarray):
            img = np.asarray(img.convert("RGB"))
        img, w, h = fit_to_canvas(img, self.canvas_size)
        c = self.canvas_size
        canvas = np.zeros((1, c, c, 3), np.uint8)
        oy, ox = (c - h) // 2, (c - w) // 2
        canvas[0, oy: oy + h, ox: ox + w] = img
        canvas_dev = torch.from_numpy(canvas).to(self.device)

        img_stats = None
        if self.model.meta.use_img_stat_features:
            with torch.inference_mode():
                img_stats = image_stats_batch(
                    canvas_dev, torch.from_numpy(make_stat_params(w, h, c)[None]))
            img_stats = img_stats[0].cpu().numpy()

        parts = []
        for encoder in self.encoders:
            params = make_crop_params(w, h, c, encoder.img_resolution, ALL_CROPS)[None]
            emb = encoder.embed_crops(canvas_dev, params)[0].float().cpu().numpy()  # [4, D]
            by_name = dict(zip(ALL_CROPS, emb))
            for crop in self.model.meta.crop_names:
                key = resolve_crop_key(by_name, crop)
                if key is None:
                    raise KeyError(f"crop {crop} unavailable")
                parts.append(by_name[key])
            if img_stats is not None:  # appended per model, as the trainer does
                parts.append(img_stats)
        features = np.concatenate(parts, axis=0)[None]
        score = float(self.model.predict(features)[0])
        return score, features
