"""The active-learning loop as one command: label → train → predict →
re-sort (port of the JAX package's ``pipeline/loop.py``).

    python -m clip_assisted_data_labeling_tpu_torch.pipeline.loop \
        --root_dir D --clip_models ViT-L-14/openai --sort middle --laps 3

Each lap: (1) open the labelling UI over the current acquisition ordering
(the first lap has no predictions, so every prediction-driven sort keeps
the natural order); (2) retrain the regressor on all labels so far; (3)
predict the whole dataset, which re-sorts the next lap. The loop ends after
``--laps`` laps, or early when a lap adds no new label. Each lap prints its
seconds in labelling, training and predicting.

Train and predict run on ``--device`` (default ``cuda``; ``cpu`` for the
CPU), as do the diversity sorts. ``--backend headless --keys '3,7,q;9,1,q'``
scripts the laps (';' between laps, ',' between keys) and prints the uuids
each lap showed.
"""
from __future__ import annotations

import argparse
import os

import torch

from clip_assisted_data_labeling_tpu_torch.config import TrainConfig
from clip_assisted_data_labeling_tpu_torch.ui.sorting import SORT_OPTIONS
from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device
from clip_assisted_data_labeling_tpu_torch.utils.timer import StageTimer


def run_loop(
    root_dir: str,
    cfg: TrainConfig,
    sort: str = "middle",
    laps: int = 3,
    backend=None,
    backend_factory=None,
    models_dir: str = "models",
    batch_size: int = 512,
    device: str | torch.device = "cuda",
) -> list[dict]:
    """Drive ≥1 label→train→predict laps on ``device``. Returns one summary
    dict per lap.

    ``backend_factory`` (lap_index → LabelBackend) supplies the labelling
    backend per lap; default is the interactive OpenCV window each lap."""
    from clip_assisted_data_labeling_tpu_torch.pipeline.label import label_dataset
    from clip_assisted_data_labeling_tpu_torch.pipeline.predict import predict_labels
    from clip_assisted_data_labeling_tpu_torch.pipeline.train import (
        load_training_data,
        save_model,
        train_regressor,
    )
    from clip_assisted_data_labeling_tpu_torch.ui.backend import OpenCVBackend

    device = resolve_device(device)
    root_dir = os.path.abspath(root_dir)
    parent, name = os.path.split(root_dir.rstrip(os.sep))
    if backend_factory is None:
        if backend is not None:
            one = backend
            backend_factory = lambda _lap: one  # noqa: E731
        else:
            backend_factory = lambda _lap: OpenCVBackend()  # noqa: E731

    history: list[dict] = []
    prev_labeled = -1
    for lap in range(laps):
        timer = StageTimer()
        with timer.time("label"):
            db = label_dataset(root_dir, backend_factory(lap), sort=sort, device=device)
        n_labeled = db.n_labeled()
        if n_labeled == prev_labeled:
            print(f"Lap {lap + 1}: no new labels — stopping the loop.")
            break
        prev_labeled = n_labeled

        with timer.time("train"):
            feats, labels, models = load_training_data(
                parent, [name], list(cfg.clip_models_to_use), list(cfg.crop_names),
                cfg.use_img_stat_features,
            )
            model, train_hist = train_regressor(feats, labels, cfg, models,
                                                plot_dir=parent, device=device)
            path = save_model(model, train_hist, cfg, out_dir=models_dir)
        with timer.time("predict"):
            n_pred = predict_labels(root_dir, path, batch_size=batch_size,
                                    copy_imgs_fraction=0.0, device=device)
        summary = {
            "lap": lap + 1,
            "labels": n_labeled,
            "predicted": n_pred,
            "model_path": path,
            "final_train_loss": float(train_hist["train"][-1]),
        }
        history.append(summary)
        print(f"Lap {lap + 1}/{laps}: {n_labeled} labels, {n_pred} predictions"
              f" — next lap re-sorts by '{sort}'")
        print(f"lap {lap + 1} timing: label {timer.totals['label']:.3f} s, train "
              f"{timer.totals['train']:.3f} s, predict {timer.totals['predict']:.3f} s "
              f"({device.type})")
    return history


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root_dir", type=str, required=True)
    parser.add_argument("--laps", type=int, default=3)
    parser.add_argument("--sort", type=str, default="middle",
                        choices=list(SORT_OPTIONS))
    parser.add_argument("--clip_models", type=str, nargs="+", default=["all"])
    parser.add_argument("--crop_names", type=str, nargs="+",
                        default=["centre_crop", "subcrop2_0.1"])
    parser.add_argument("--use_img_stat_features", action="store_true")
    parser.add_argument("--model_name", type=str, default="loop_regressor")
    parser.add_argument("--models_dir", type=str, default="models")
    parser.add_argument("--n_epochs", type=int, default=60)
    parser.add_argument("--test_fraction", type=float, default=0.15)
    parser.add_argument("--hidden_sizes", type=int, nargs="+",
                        default=[264, 128, 64])
    parser.add_argument("--batch_size", type=int, default=512,
                        help="predict batch size")
    parser.add_argument("--backend", type=str, default="opencv",
                        choices=["opencv", "headless"])
    parser.add_argument("--keys", type=str, default="",
                        help="';'-separated per-lap key scripts for "
                        "--backend headless (each lap's keys comma-separated,"
                        " e.g. '3,7,q;9,1,q')")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = TrainConfig(
        clip_models_to_use=tuple(args.clip_models),
        crop_names=tuple(args.crop_names),
        use_img_stat_features=args.use_img_stat_features,
        n_epochs=args.n_epochs,
        test_fraction=args.test_fraction,
        hidden_sizes=tuple(args.hidden_sizes),
        model_name=args.model_name,
    )
    backend_factory = None
    headless = []
    if args.backend == "headless":
        from clip_assisted_data_labeling_tpu_torch.ui.backend import HeadlessBackend

        scripts = [s.split(",") if s else ["quit"]
                   for s in args.keys.split(";")]

        def backend_factory(lap):
            keys = scripts[lap] if lap < len(scripts) else ["quit"]
            headless.append(HeadlessBackend([k if k != "q" else "quit" for k in keys]))
            return headless[-1]

    history = run_loop(
        args.root_dir, cfg, sort=args.sort, laps=args.laps,
        backend_factory=backend_factory, models_dir=args.models_dir,
        batch_size=args.batch_size, device=device,
    )
    if headless:
        from clip_assisted_data_labeling_tpu_torch.pipeline.label import print_shown

        for lap, backend in enumerate(headless):
            print_shown(backend, f"lap {lap + 1}")
    print(f"Loop finished: {len(history)} laps, "
          f"{history[-1]['labels'] if history else 0} total labels.")
    return history


if __name__ == "__main__":
    main()
