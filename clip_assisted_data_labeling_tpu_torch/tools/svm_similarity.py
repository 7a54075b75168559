"""SVM-based similarity ranking (port of the JAX package's
``tools/svm_similarity.py``): the context images are positives, the search
set is the background, a balanced linear SVM is fit on the embeddings, and
the search set is ranked by decision-function margin.

    python -m clip_assisted_data_labeling_tpu_torch.tools.svm_similarity \\
        --context_dir <dir> --search_dir <dir> [--svm_c 0.1] [--device cpu]

The JAX tool fits ``sklearn.svm.LinearSVC(class_weight="balanced")``; the
port solves the same problem with its own solver (:func:`newton_svm`), in
float64 on the device (``cuda`` unless ``--device cpu``): liblinear's
L2-regularized squared-hinge objective

    ½‖[w; b]‖² + Σᵢ Cᵢ · max(0, 1 − yᵢ (w·xᵢ + b))²

with the bias a feature of value 1 that is regularized (liblinear's
``intercept_scaling=1``) and ``Cᵢ = C · n / (2 · n_class(i))``
(``class_weight="balanced"``). The objective is strictly convex, so both
solvers reach the same optimum; the margins agree with sklearn's to the
tolerances the solvers stop at. The embeddings' loaders are
``tools/find_similar_imgs.py``'s.
"""
from __future__ import annotations

import argparse
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.tools.find_similar_imgs import (
    _collect_embeddings,
    existing,
)
from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device

ARMIJO = 0.01  # the line search's sufficient-decrease fraction
MIN_STEP = 2.0 ** -40  # the line search gives up below this step
GRAD_TOL = 1e-9  # converged at this gradient norm relative to the first


def newton_svm(x: torch.Tensor, y: torch.Tensor, c: torch.Tensor,
               max_iter: int = 10000) -> tuple[torch.Tensor, dict]:
    """Minimize ½‖w‖² + Σᵢ cᵢ · max(0, 1 − yᵢ xᵢ·w)² over w, for rows ``x``
    [n, d] (the bias column included), labels ``y`` [n] in {−1, +1} and
    weights ``c`` [n], all float64 on one device.

    A primal Newton method: each step solves the generalized Newton system
    (I + 2 X_Aᵀ diag(c_A) X_A) δ = −g over the active rows A (those with
    1 − yᵢ xᵢ·w > 0) by Cholesky, then halves the step from 1 until the
    objective falls by ``ARMIJO`` of the directional derivative. It stops
    when ‖g‖ ≤ ``GRAD_TOL`` · ‖g₀‖ (g₀ the gradient at w = 0), after
    ``max_iter`` Newton steps, or when the line search finds no decrease
    above ``MIN_STEP``. Returns (w, info): the Newton steps taken, the final
    and first gradient norms, and whether it converged."""
    d = x.shape[1]
    w = x.new_zeros(d)
    slack = torch.ones_like(y)  # 1 − yᵢ xᵢ·w at w = 0

    def objective(w, slack):
        return 0.5 * (w @ w) + (c * slack.clamp(min=0.0) ** 2).sum()

    def gradient(w, slack):
        return w - 2.0 * (x.T @ (c * y * slack.clamp(min=0.0)))

    f, g = objective(w, slack), gradient(w, slack)
    g0 = float(torch.linalg.vector_norm(g))
    gnorm, steps = g0, 0
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    while gnorm > GRAD_TOL * g0 and steps < max_iter:
        active = slack > 0
        xa = x[active]
        hess = eye + 2.0 * (xa.T @ (c[active, None] * xa))
        delta = torch.cholesky_solve(-g[:, None], torch.linalg.cholesky(hess))[:, 0]
        z = y * (x @ delta)  # the slack falls by t·z along the step
        slope = float(g @ delta)
        t = 1.0
        while True:
            w_t, slack_t = w + t * delta, slack - t * z
            f_t = objective(w_t, slack_t)
            if float(f_t) <= float(f) + ARMIJO * t * slope or t < MIN_STEP:
                break
            t /= 2.0
        if t < MIN_STEP:
            break
        w, slack, f = w_t, slack_t, f_t
        g = gradient(w, slack)
        gnorm = float(torch.linalg.vector_norm(g))
        steps += 1
    info = {"steps": steps, "grad_norm": gnorm, "grad_norm_0": g0,
            "converged": gnorm <= GRAD_TOL * g0}
    return w, info


def _norm(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def svm_rank(context_emb: np.ndarray, search_emb: np.ndarray, c: float = 0.1,
             max_iter: int = 10000, device: str | torch.device = "cuda",
             info: dict | None = None) -> np.ndarray:
    """Margin score per search row, higher = more context-like (float64).
    The rows are L2-normalized on the host in their own dtype, as the JAX
    tool does, and the SVM is fit on ``device`` (:func:`newton_svm`, at most
    ``max_iter`` Newton steps; where it stops short of convergence it says
    so). ``info``, where given, receives the solver's figures."""
    dev = resolve_device(device)
    ctx, search = _norm(context_emb), _norm(search_emb)
    n_pos, n_neg = len(ctx), len(search)
    n = n_pos + n_neg
    x = torch.from_numpy(np.concatenate([ctx, search])).to(dev, torch.float64)
    x = torch.cat([x, x.new_ones((n, 1))], dim=1)  # the bias feature
    y = torch.cat([x.new_ones(n_pos), -x.new_ones(n_neg)])
    weights = torch.cat([x.new_full((n_pos,), c * n / (2 * n_pos)),
                         x.new_full((n_neg,), c * n / (2 * n_neg))])
    w, solver = newton_svm(x, y, weights, max_iter=max_iter)
    if not solver["converged"]:
        print(f"svm_rank: the Newton solver stopped after {solver['steps']} steps without "
              f"converging (gradient norm {solver['grad_norm'] / solver['grad_norm_0']:.3g} "
              f"of its first); increase max_iter")
    if info is not None:
        info.update(solver)
    return (x[n_pos:] @ w).cpu().numpy()


def find_similar_svm(context_dir: str, search_dir: str, output_dir: str,
                     clip_models: list[str], crop_name: str, top_n: int,
                     c: float = 0.1, device: str | torch.device = "cuda",
                     timings: dict | None = None) -> list[tuple[float, str]]:
    """The top ``top_n`` search images by SVM margin, copied into
    ``output_dir``; returns [(score, image path)]. ``timings``, where given,
    receives the seconds of the embedding collection, the device fit and
    scores and the copies, and the solver's figures."""
    t0 = time.perf_counter()
    ctx_names, _p, ctx_emb = _collect_embeddings(context_dir, clip_models, crop_name)
    names, pt_paths, emb = _collect_embeddings(search_dir, clip_models, crop_name)
    if not len(ctx_emb) or not len(emb):
        print("Missing embeddings in context or search dir")
        return []
    ctx_set = set(ctx_names)
    imgs = [p[:-3] + ".jpg" for p in pt_paths]
    keep = [(i, img) for i, (img, p, ok) in enumerate(zip(imgs, pt_paths, existing(imgs)))
            if ok and os.path.basename(p) not in ctx_set]
    if not keep:
        print("No search images with sibling .jpg files — nothing to rank")
        return []
    t1 = time.perf_counter()
    solver: dict = {}
    scores = svm_rank(ctx_emb, emb[[i for i, _ in keep]], c=c, device=device, info=solver)
    order = np.argsort(-scores)[:top_n]
    t2 = time.perf_counter()

    os.makedirs(output_dir, exist_ok=True)
    results = []
    for rank in order:
        score, img = float(scores[rank]), keep[rank][1]
        shutil.copy(img, os.path.join(output_dir, f"{score:+.3f}_{Path(img).stem}.jpg"))
        results.append((score, img))
    print(f"Copied {len(results)} SVM-ranked images to {output_dir}")
    if timings is not None:
        timings.update(collect_s=t1 - t0, device_s=t2 - t1, copy_s=time.perf_counter() - t2,
                       **solver)
    return results


def main(argv=None, timings: dict | None = None):
    """The CLI; returns :func:`find_similar_svm`'s results and fills
    ``timings`` where given."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--context_dir", required=True)
    parser.add_argument("--search_dir", required=True)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--clip_models_to_use", type=str, nargs="+", default=["all"])
    parser.add_argument("--crop_name_to_use", default="square_padded_crop")
    parser.add_argument("--top_n", default=30, type=int)
    parser.add_argument("--svm_c", default=0.1, type=float)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    out = args.output_dir or os.path.join(args.context_dir, "_svm_similar")
    return find_similar_svm(args.context_dir, args.search_dir, out, args.clip_models_to_use,
                            args.crop_name_to_use, args.top_n, args.svm_c, device, timings)


if __name__ == "__main__":
    main()
