"""Matplotlib artifacts matching the reference's observability outputs (port
of the JAX package's ``utils/plots.py``): training_progress.png,
test_set_predictions.png and label_distribution_<dir>.png.

matplotlib is imported at call time (``_plt``), so nothing that merely
imports this module needs it.
"""
from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_losses(train_losses, test_losses, lrs, out_path="training_progress.png",
                percentile_cutoff=99.75):
    plt = _plt()
    plt.figure(figsize=(16, 8))
    plt.subplot(1, 2, 1)
    plt.plot(train_losses, label="Train")
    plt.plot(test_losses, label="Test")
    if test_losses:
        plt.axhline(y=min(test_losses), color="r", linestyle="--", label="Best test loss")
    all_losses = list(train_losses) + list(test_losses)
    if all_losses:
        plt.ylim(0, np.percentile(all_losses, percentile_cutoff))
    plt.xlabel("Epoch")
    plt.ylabel("MSE loss")
    plt.legend()
    plt.subplot(1, 2, 2)
    plt.plot(lrs, label="Learning Rate")
    plt.xlabel("Epoch")
    plt.ylabel("Learning Rate")
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close()


def plot_test_scatter(labels, preds, epoch, out_path="test_set_predictions.png"):
    """Scatter of predictions against labels; returns r²."""
    plt = _plt()
    labels = np.asarray(labels).reshape(-1)
    preds = np.asarray(preds).reshape(-1)
    ss_res = float(np.sum((labels - preds) ** 2))
    ss_tot = float(np.sum((labels - labels.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    plt.figure(figsize=(8, 8))
    plt.scatter(labels, preds, alpha=0.1)
    plt.xlabel("True labels")
    plt.ylabel("Predicted labels")
    plt.plot([0, 1], [0, 1], color="r", linestyle="--")
    plt.title(f"Epoch {epoch}, r² = {r2:.3f}")
    plt.xlim(0, 1)
    plt.ylim(0, 1)
    plt.savefig(out_path)
    plt.close()
    return r2


def plot_label_distribution(predicted_labels, root_dir, max_x=1.0):
    """Histogram of the finite predicted labels, saved beside root_dir;
    returns its path."""
    plt = _plt()
    vals = np.asarray(predicted_labels, dtype=np.float64)
    vals = vals[np.isfinite(vals)]
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.hist(vals, bins=100, alpha=0.75, color="blue", edgecolor="black")
    ax.set_title(f"Label Distribution for {os.path.basename(root_dir)}", fontsize=18)
    ax.set_xlabel("Predicted Label", fontsize=14)
    ax.set_ylabel("Frequency", fontsize=14)
    ax.grid(axis="y", alpha=0.75, linestyle="--")
    if len(vals):
        textstr = f"$\\mu={np.mean(vals):.2f}$\n$\\sigma={np.std(vals):.2f}$"
        ax.text(0.05, 0.95, textstr, transform=ax.transAxes, fontsize=12,
                verticalalignment="top",
                bbox=dict(boxstyle="round", facecolor="white", alpha=0.8))
    ax.set_xlim(left=0, right=max_x)
    out = os.path.join(
        os.path.dirname(root_dir.rstrip("/")),
        f"label_distribution_{os.path.basename(root_dir.rstrip('/'))}.png",
    )
    fig.savefig(out)
    plt.close(fig)
    return out
