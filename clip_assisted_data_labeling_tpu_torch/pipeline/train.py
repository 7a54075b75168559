"""Stage 4 — train the FC label regressor on (embedding → label) pairs (port
of the JAX package's ``pipeline/train.py``, one device).

Features come from the columnar store where every model has one, else from
the ``.pt`` sidecars. The dataset goes up to the device once; each epoch
draws a permutation there (``torch.randperm`` on a device generator) and
indexes its batches on the device, and each step is an eager forward,
``backward`` and ``torch.optim.Adam`` step.

The training semantics are the JAX package's: Adam with L2 weight decay
folded into the gradient (``Adam(weight_decay=…)``, not AdamW),
CosineAnnealingWarmRestarts stepped per epoch, MSE on sigmoid outputs over
labels min-max scaled to [0, 1] (the bounds kept in the checkpoint), or
softmax cross-entropy over the distinct label values under
``--classification``; the dummy-mean baseline (or the test accuracy)
reported beside the test loss each epoch, and the loss and scatter plots
where matplotlib is installed.

CLI: the JAX stage's flags plus ``--device`` (default ``cuda``; ``cpu`` for
the CPU). ``--debug_nans`` (the JAX stage's ``jax_debug_nans``) checks each
step's loss and, after the optimizer step, the parameters, and raises
``FloatingPointError`` naming the epoch and the step (0-based) at the first
non-finite value; without it nothing is checked.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from clip_assisted_data_labeling_tpu_torch.config import TrainConfig
from clip_assisted_data_labeling_tpu_torch.models.regressor import (
    RegressorMeta,
    SimpleFCRegressor,
)
from clip_assisted_data_labeling_tpu_torch.store.columnar import (
    EmbeddingStore,
    assemble_batch_from_stores,
    list_models,
)
from clip_assisted_data_labeling_tpu_torch.store.database import (
    LabelDatabase,
    database_path_for,
)
from clip_assisted_data_labeling_tpu_torch.store.sidecar import assemble_features, read_sidecar
from clip_assisted_data_labeling_tpu_torch.utils import plots
from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device


# --------------------------------------------------------------------------------
# data loading
# --------------------------------------------------------------------------------
def load_training_data(
    train_data_dir: str,
    train_data_names: list[str],
    clip_models_to_use: list[str],
    crop_names: list[str],
    use_img_stat_features: bool,
):
    """(features [N, F] float32, labels [N] float32, models) over one or
    more labelled datasets ``<train_data_dir>/<name>`` with their CSVs
    ``<train_data_dir>/<name>.csv``. Rows are shuffled under numpy's global
    seed, as the JAX package shuffles them."""
    features, labels = [], []
    resolved_models = list(clip_models_to_use)

    for name in train_data_names:
        root = os.path.join(train_data_dir, name)
        csv_path = database_path_for(root)
        if not os.path.exists(csv_path):
            raise FileNotFoundError(f"no label database {csv_path}")
        db = LabelDatabase.load_or_create(root)
        label_col = db.column("label")
        has_label = ~np.isnan(label_col)
        row_uuids = [u for u, ok in zip(db.column("uuid"), has_label) if ok]
        row_labels = label_col[has_label]
        # pandas' data.sample(frac=1) under the global seed draws exactly
        # np.random.permutation(n): the JAX package's row order, and with it
        # its test split, without pandas
        order = np.random.permutation(len(row_uuids))
        row_uuids = [row_uuids[i] for i in order]
        row_labels = row_labels[order]

        if resolved_models[0] == "all":
            resolved_models = _discover_models(root, row_uuids)
            print(f"----> Using all found clip models: {resolved_models}")

        stores = {m: EmbeddingStore.open(root, m) for m in resolved_models
                  if EmbeddingStore.exists(root, m)}

        if len(stores) == len(resolved_models):
            # a row is skipped exactly where the per-uuid assembly would raise
            # (a uuid absent from a store, or its row invalid)
            keep, feats = assemble_batch_from_stores(
                stores, resolved_models, crop_names, use_img_stat_features, row_uuids)
            features.extend(feats)
            labels.extend(float(v) for v in row_labels[keep])
            n_samples, skips = int(keep.sum()), int((~keep).sum())
        else:
            n_samples, skips = 0, 0
            for uuid, label in zip(row_uuids, row_labels):
                try:
                    sidecar = read_sidecar(os.path.join(root, f"{uuid}.pt"))
                    feats = assemble_features(
                        sidecar, resolved_models, crop_names, use_img_stat_features)
                    features.append(feats)
                    labels.append(float(label))
                    n_samples += 1
                except Exception:  # a missing or foreign sidecar: skip the row
                    skips += 1
        print(f"Loaded {n_samples} samples from {name}" + (f" (skipped {skips})" if skips else ""))

    return np.stack(features).astype(np.float32), np.asarray(labels, np.float32), resolved_models


def _discover_models(root: str, uuids: list[str]) -> list[str]:
    names = list_models(root)
    if names:
        return names
    for uuid in uuids[:50]:
        p = os.path.join(root, f"{uuid}.pt")
        if os.path.exists(p):
            return list(read_sidecar(p).keys())
    raise FileNotFoundError(f"No embeddings found under {root}")


# --------------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------------
def _lr_at_epoch(epoch, cfg: TrainConfig) -> float:
    """CosineAnnealingWarmRestarts(T_0=restart_epochs, T_mult=1) stepped per epoch."""
    t_cur = epoch % cfg.restart_epochs
    return cfg.min_lr + (cfg.lr - cfg.min_lr) * (
        1 + np.cos(np.pi * t_cur / cfg.restart_epochs)
    ) / 2


def make_optimizer(model: SimpleFCRegressor, cfg: TrainConfig) -> torch.optim.Adam:
    """torch's Adam with L2 weight decay (the reference's optimizer); the
    rate is set each epoch from ``_lr_at_epoch``."""
    return torch.optim.Adam(model.net.parameters(), lr=cfg.lr, weight_decay=cfg.weight_decay)


def _xent(logits: torch.Tensor, y_idx: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-entropy for class indices carried as floats."""
    return -F.log_softmax(logits, dim=-1).gather(1, y_idx.long()[:, None])[:, 0]


def _pad_to_batches(x, y, batch_size):
    """Pad (x, y) to a multiple of batch_size with zero-weight rows; returns
    (x, y, w). The padding is less than one batch, so no batch is all
    padding, and it is shuffled in with the rest each epoch."""
    n = len(x)
    n_batches = max(1, (n + batch_size - 1) // batch_size)
    pad = n_batches * batch_size - n
    w = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        y = np.concatenate([y, np.zeros(pad, y.dtype)])
    return x, y, w


def _check_finite(model: SimpleFCRegressor, loss: torch.Tensor, epoch: int, step: int) -> None:
    """``--debug_nans``: raise ``FloatingPointError`` naming the epoch and
    the step (0-based) if the step's loss or an updated parameter is not
    finite (one host sync a step)."""
    params = list(model.net.named_parameters())
    ok = torch.stack([torch.isfinite(loss).all()]
                     + [torch.isfinite(p).all() for _, p in params]).cpu().numpy()
    if ok.all():
        return
    where = ("the loss" if not ok[0] else
             "parameter " + next(n for (n, _), good in zip(params, ok[1:]) if not good)
             + " after the optimizer step")
    raise FloatingPointError(f"debug_nans: non-finite value in {where} at epoch {epoch}, "
                             f"step {step}")


def _train_epoch(model: SimpleFCRegressor, opt: torch.optim.Optimizer, x, y, w,
                 perm: torch.Tensor, lr: float, batch_size: int, n_classes: int,
                 gen: torch.Generator | None, debug_nans: bool = False,
                 epoch: int = 0) -> torch.Tensor:
    """One epoch over the padded device arrays x, y, w in the order of
    ``perm`` (a permutation of their rows on their device, drawn by the
    caller; the rows are gathered once, as the JAX epoch does, and each
    batch is a slice): forward, backward and an Adam step a batch, each
    batch's loss Σ(per-sample loss · w) / max(Σw, 1). Dropout draws its
    masks from ``gen`` (None: no dropout). ``debug_nans``: each step's loss
    and updated parameters are checked (:func:`_check_finite`; ``epoch``
    names the epoch). Returns the mean batch loss as a device scalar."""
    for group in opt.param_groups:
        group["lr"] = lr
    net = model.net
    xs, ys, ws = x[perm], y[perm], w[perm]
    losses = []
    for step, start in enumerate(range(0, x.shape[0] - batch_size + 1, batch_size)):
        end = start + batch_size
        xi, yi, wi = xs[start:end], ys[start:end], ws[start:end]
        if n_classes:
            per = _xent(net(xi, gen, head="linear"), yi)
        else:
            per = (net(xi, gen)[:, 0] - yi) ** 2
        loss = torch.sum(per * wi) / torch.clamp(torch.sum(wi), min=1.0)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if debug_nans:
            _check_finite(model, loss, epoch, step)
        losses.append(loss.detach())
    return torch.stack(losses).mean()


@torch.no_grad()
def _evaluate(model: SimpleFCRegressor, x_test, y_test, n_classes: int):
    """(test loss, third metric) as device scalars: MSE and the dummy-mean
    baseline's MSE, or cross-entropy and accuracy under classification;
    (-1, -1) without a test set."""
    if x_test.shape[0] == 0:
        return x_test.new_tensor(-1.0), x_test.new_tensor(-1.0)
    if n_classes:
        logits = model.net(x_test, head="linear")
        return (torch.mean(_xent(logits, y_test)),
                torch.mean((logits.argmax(dim=-1) == y_test.long()).float()))
    out = model.net(x_test)[:, 0]
    return (torch.mean((out - y_test) ** 2),
            torch.mean((torch.mean(y_test) - y_test) ** 2))


def _train_run(model: SimpleFCRegressor, x, y, w, x_test, y_test, cfg: TrainConfig,
               n_classes: int, gen: torch.Generator, debug_nans: bool = False):
    """The whole run from ``model``'s weights (trained in place): per epoch
    a permutation from ``gen`` on the device, ``_train_epoch`` at that
    epoch's rate, then the test metrics. Nothing returns to the host until
    the end. Returns (history [3, n_epochs] numpy: train loss, test loss,
    third metric; lrs)."""
    opt = make_optimizer(model, cfg)
    lrs = [_lr_at_epoch(e, cfg) for e in range(cfg.n_epochs)]
    dropout_gen = gen if cfg.dropout_prob > 0.0 else None
    history = []
    for epoch, lr in enumerate(lrs):
        perm = torch.randperm(x.shape[0], generator=gen, device=x.device)
        train_loss = _train_epoch(model, opt, x, y, w, perm, lr, cfg.batch_size, n_classes,
                                  dropout_gen, debug_nans, epoch)
        history.append(torch.stack([train_loss, *_evaluate(model, x_test, y_test,
                                                          n_classes)]))
    return torch.stack(history, dim=1).cpu().numpy(), lrs


def _prepare_labels(labels: np.ndarray, cfg: TrainConfig):
    """(targets, class_values): labels min-max scaled to [0, 1], or under
    classification the index of each label among the sorted distinct
    values (as float32)."""
    if not cfg.classification:
        lmin, lmax = float(labels.min()), float(labels.max())
        denom = (lmax - lmin) if lmax > lmin else 1.0
        return (labels - lmin) / denom, None
    class_values = np.unique(labels.astype(np.float32))
    if len(class_values) < 2:
        raise ValueError(
            f"--classification needs >=2 distinct label values, got "
            f"{class_values.tolist()}"
        )
    return (np.searchsorted(class_values, labels.astype(np.float32)).astype(np.float32),
            class_values)


def _split(n: int, cfg: TrainConfig):
    """(test rows, train rows): the JAX package's split, the first
    test_fraction·n of a permutation from numpy's default_rng(random_seed)."""
    test_size = int(cfg.test_fraction * n)
    perm = np.random.default_rng(cfg.random_seed).permutation(n)
    return perm[:test_size], perm[test_size:]


def _make_meta(features, labels, cfg: TrainConfig, clip_models, class_values) -> RegressorMeta:
    return RegressorMeta(
        clip_models=tuple(clip_models),
        crop_names=tuple(cfg.crop_names),
        input_size=int(features.shape[1]),
        hidden_sizes=tuple(cfg.hidden_sizes),
        output_size=len(class_values) if class_values is not None else 1,
        use_img_stat_features=cfg.use_img_stat_features,
        dropout_prob=cfg.dropout_prob,
        data_min=float(labels.min()),
        data_max=float(labels.max()),
        class_values=(tuple(float(v) for v in class_values)
                      if class_values is not None else None),
    )


def train_regressor(
    features: np.ndarray,
    labels: np.ndarray,
    cfg: TrainConfig,
    clip_models: list[str],
    plot_dir: str = ".",
    verbose: bool = True,
    device: str | torch.device = "cuda",
    debug_nans: bool = False,
):
    """Train a fresh regressor (initialized from ``cfg.random_seed``) on
    ``device``. Returns (model, history): history holds the per-epoch train
    and test losses and third metric, the rates, the number of training
    rows, and the training's seconds and optimizer steps. ``debug_nans``:
    raise ``FloatingPointError`` at the first non-finite loss or parameter
    (:func:`_check_finite`)."""
    device = resolve_device(device)
    targets, class_values = _prepare_labels(labels, cfg)
    if class_values is not None:
        print(f"Classification over {len(class_values)} classes: "
              f"{class_values.tolist()}")
    test_idx, train_idx = _split(len(features), cfg)
    if verbose:
        print(f"Training on {len(train_idx)} samples, testing on {len(test_idx)}.")

    meta = _make_meta(features, labels, cfg, clip_models, class_values)
    model = SimpleFCRegressor.create(meta, cfg.random_seed, device)
    if cfg.print_network_layout:
        print(model.describe())

    xp, yp, wp = _pad_to_batches(features[train_idx], targets[train_idx], cfg.batch_size)
    x, y, w = (torch.from_numpy(a).to(device) for a in (xp, yp, wp))
    x_test = torch.from_numpy(features[test_idx]).to(device)
    y_test = torch.from_numpy(targets[test_idx]).to(device)
    n_classes = len(class_values) if class_values is not None else 0
    gen = torch.Generator(device=device).manual_seed(cfg.random_seed + 1)

    t0 = time.perf_counter()
    hist, lrs = _train_run(model, x, y, w, x_test, y_test, cfg, n_classes, gen, debug_nans)
    seconds = time.perf_counter() - t0  # the history's copy to the host waited for the device
    train_losses, test_losses, third_metric = (row.astype(float).tolist() for row in hist)

    loss_name = "xent" if n_classes else "mse"
    third_name = "test acc" if n_classes else "dummy"
    if verbose:
        for epoch in range(0, cfg.n_epochs, 2):
            print(
                f"Epoch {epoch + 1}/{cfg.n_epochs}, train-{loss_name}: "
                f"{train_losses[epoch]:.4f}, lr: {lrs[epoch]:.6f}, "
                f"test {loss_name}: {test_losses[epoch]:.4f} "
                f"({third_name}: {third_metric[epoch]:.4f})"
            )
    if len(test_idx) > 0 and verbose:
        best = int(np.argmin(test_losses))
        print(f"---> Best test {loss_name} loss: {test_losses[best]:.4f} "
              f"in epoch {best + 1}")
        if n_classes:
            counts = np.bincount(targets[test_idx].astype(np.int64), minlength=n_classes)
            print(f"     (majority-class baseline accuracy: "
                  f"{counts.max() / max(counts.sum(), 1):.4f}; final test "
                  f"accuracy: {third_metric[-1]:.4f})")
    plots.plot_or_say(plots.plot_losses, train_losses, test_losses, lrs,
                      out_path=os.path.join(plot_dir, "training_progress.png"))
    if len(test_idx) > 0:
        # the scatter stays in label units: class indices map back to values
        y_plot = (class_values[targets[test_idx].astype(np.int64)] if n_classes
                  else targets[test_idx])
        final = model._scores(x_test).cpu().numpy()
        plots.plot_or_say(plots.plot_test_scatter, y_plot, final, cfg.n_epochs - 1,
                          out_path=os.path.join(plot_dir, "test_set_predictions.png"))

    # "third": the dummy-mean baseline's test MSE, or the test accuracy
    history = {"train": train_losses, "test": test_losses, "third": third_metric, "lrs": lrs,
               "n_train": len(train_idx), "seconds": seconds,
               "steps": cfg.n_epochs * (len(xp) // cfg.batch_size)}
    return model, history


def save_model(model: SimpleFCRegressor, history: dict, cfg: TrainConfig,
               out_dir: str = "models") -> str:
    """The reference's self-describing file name, under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    stamp = time.strftime("%Y-%m-%d_%H:%M:%S")
    # with test_fraction=0 the test history holds the -1.0 sentinel: name
    # the train loss instead, labelled as such
    loss_name = "xent" if model.meta.class_values is not None else "mse"
    mse = (f"{history['test'][-1]:.4f}_{loss_name}" if history["test"][-1] >= 0
           else f"{history['train'][-1]:.4f}_train_{loss_name}")
    name = (
        f"{cfg.model_name}_{stamp}_{history['n_train'] / 1000:.1f}k_imgs_"
        f"{cfg.n_epochs}_epochs_{mse}.npz"
    )
    path = os.path.join(out_dir, name)
    model.save(path)
    print("Final model saved as:", path)
    if cfg.export_torch:
        pth = path[: -len(".npz")] + ".pth"
        model.save_torch_pickle(pth)
        print("Reference-compatible torch pickle saved as:", pth)
    return path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--train_data_dir", type=str, required=True)
    parser.add_argument("--train_data_names", type=str, nargs="+", required=True)
    parser.add_argument("--model_name", type=str, default="regressor")
    parser.add_argument("--dont_save", action="store_true")
    parser.add_argument("--export_torch", action="store_true",
                        help="also save a reference-loadable .pth module "
                        "pickle next to the .npz checkpoint")
    parser.add_argument("--clip_models_to_use", metavar="S", type=str, nargs="+",
                        default=["all"])
    parser.add_argument("--crop_names", type=str, nargs="+",
                        default=["centre_crop", "subcrop2_0.1"])
    parser.add_argument("--use_img_stat_features", action="store_true")
    parser.add_argument("--test_fraction", type=float, default=0.25)
    parser.add_argument("--n_epochs", type=int, default=60)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--min_lr", type=float, default=1e-6)
    parser.add_argument("--restart_epochs", type=int, default=10)
    parser.add_argument("--weight_decay", type=float, default=6e-4)
    parser.add_argument("--dropout_prob", type=float, default=0.5)
    parser.add_argument("--hidden_sizes", type=int, nargs="*",
                        default=[264, 128, 64],
                        help="hidden layer widths; pass with NO values for a "
                        "pure linear(-logistic) model")
    parser.add_argument("--random_seed", type=int, default=42)
    parser.add_argument("--print_network_layout", action="store_true",
                        help="print the regressor layer layout")
    parser.add_argument("--classification", action="store_true",
                        help="train a softmax classifier over the distinct "
                        "label values instead of the sigmoid regressor; "
                        "predicted_label becomes the softmax-expected label value")
    parser.add_argument("--debug_nans", action="store_true",
                        help="check each step's loss and updated parameters and raise "
                        "FloatingPointError, naming the epoch and step, at the first "
                        "non-finite value (the port's jax_debug_nans)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg = TrainConfig(
        clip_models_to_use=args.clip_models_to_use,
        crop_names=args.crop_names,
        use_img_stat_features=args.use_img_stat_features,
        test_fraction=args.test_fraction,
        n_epochs=args.n_epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        min_lr=args.min_lr,
        restart_epochs=args.restart_epochs,
        weight_decay=args.weight_decay,
        dropout_prob=args.dropout_prob,
        hidden_sizes=args.hidden_sizes,
        random_seed=args.random_seed,
        model_name=args.model_name,
        dont_save=args.dont_save,
        export_torch=args.export_torch,
        print_network_layout=args.print_network_layout,
        classification=args.classification,
    )
    device = resolve_device(args.device)
    np.random.seed(cfg.random_seed)
    features, labels, models = load_training_data(
        args.train_data_dir, args.train_data_names, list(cfg.clip_models_to_use),
        list(cfg.crop_names), cfg.use_img_stat_features,
    )
    print("Features shape:", features.shape, "Labels shape:", labels.shape)
    model, history = train_regressor(features, labels, cfg, models, device=device,
                                     debug_nans=args.debug_nans)
    path = None if cfg.dont_save else save_model(model, history, cfg)
    return model, history, path


if __name__ == "__main__":
    main()
