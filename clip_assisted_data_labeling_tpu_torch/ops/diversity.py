"""Diversity (farthest-point) ordering in CLIP space, on one device (port of
the JAX package's ``ops/diversity.py``).

Greedy max-min selection: track, for every image, the largest cosine
similarity to the set selected so far; each step picks the argmin and folds
that image's similarities in. The whole matrix lives on the device; each
step is a matrix-vector product, an elementwise maximum and an argmin, with
the pick kept on the device (a 0-d tensor), so the loop never waits for the
host. ``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does.

The sampled form (the reference's 100 candidates a step) takes its draws
from a ``torch.Generator`` seeded by ``seed`` on the matrix's device
(:func:`draw_candidates`), or from the caller: the JAX package draws them
from threefry keys, which torch cannot reproduce, so its tests hand the JAX
draws in.
"""
from __future__ import annotations

import numpy as np
import torch

from clip_assisted_data_labeling_tpu_torch.ops.similarity import normalize_rows
from clip_assisted_data_labeling_tpu_torch.utils.device import resolve_device
from clip_assisted_data_labeling_tpu_torch.utils.timer import StageTimer


def _fold(normed: torch.Tensor, maxsim: torch.Tensor, pick: torch.Tensor) -> None:
    """maxsim ← max(maxsim, normed · normed[pick]), then +inf at the pick
    (never picked again); ``pick`` is a one-element index tensor."""
    torch.maximum(maxsim, torch.mv(normed, normed.index_select(0, pick)[0]), out=maxsim)
    maxsim.index_fill_(0, pick, float("inf"))


def _farthest_point(normed: torch.Tensor, n_order: int, seed_idx: int) -> torch.Tensor:
    """The exact greedy order: each step the global argmin. [n_order] int64
    on the matrix's device."""
    selected = torch.empty(n_order, dtype=torch.int64, device=normed.device)
    selected[0] = seed_idx
    maxsim = torch.full((normed.shape[0],), -float("inf"), device=normed.device)
    _fold(normed, maxsim, selected[:1])
    for i in range(1, n_order):
        selected[i] = torch.argmin(maxsim)
        _fold(normed, maxsim, selected[i:i + 1])
    return selected


def _farthest_point_sampled(normed: torch.Tensor, n_order: int, seed_idx: int,
                            draws: torch.Tensor) -> torch.Tensor:
    """The reference's sampled greedy order: step i takes the argmin over
    its own candidates ``draws[i - 1]`` (drawn with replacement; an already
    selected one holds +inf, so a step whose draws are all selected repeats
    its first candidate)."""
    selected = torch.empty(n_order, dtype=torch.int64, device=normed.device)
    selected[0] = seed_idx
    maxsim = torch.full((normed.shape[0],), -float("inf"), device=normed.device)
    _fold(normed, maxsim, selected[:1])
    for i in range(1, n_order):
        cand = draws[i - 1]
        best = torch.argmin(maxsim.index_select(0, cand)).reshape(1)
        selected[i:i + 1] = cand.index_select(0, best)
        _fold(normed, maxsim, selected[i:i + 1])
    return selected


def draw_candidates(n: int, n_order: int, candidates: int, seed: int,
                    device: str | torch.device = "cuda") -> torch.Tensor:
    """The sampled form's draws: [max(n_order − 1, 0), candidates] int64
    indices in [0, n), uniform with replacement, from a generator on
    ``device`` seeded by ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, n, (max(n_order - 1, 0), candidates), generator=gen,
                         device=device)


def farthest_point_order(
    embeddings: np.ndarray, n_order: int = 500, seed_idx: int = 0,
    candidates: int | None = None, seed: int = 0, draws=None,
    device: str | torch.device = "cuda", timer: StageTimer | None = None,
) -> np.ndarray:
    """Indices of a maximally CLIP-diverse prefix of the dataset, then the
    remaining indices in their original order (the reference's contract,
    _3_label_images.py:175).

    ``candidates=None`` (default) runs the exact global farthest point;
    ``candidates=k`` runs the reference's sampled variant, k random
    candidates a step, drawn by :func:`draw_candidates` from ``seed`` unless
    ``draws`` ([n_order − 1, min(k, n)] indices) is given; a repeated pick
    (an exhausted draw) is dropped, keeping the first. ``timer``, where
    given, takes the seconds of ``prepare`` (host normalization and the
    upload) and ``order`` (the device loop, up to the prefix on the host)."""
    device = resolve_device(device)
    timer = timer or StageTimer()
    n = len(embeddings)
    n_order = min(n_order, n)
    with timer.time("prepare", n):
        normed = torch.from_numpy(normalize_rows(embeddings)).to(device)
    with timer.time("order", n_order):
        if candidates is None:
            prefix = _farthest_point(normed, n_order, seed_idx).cpu().numpy()
        else:
            k = min(candidates, n)
            if draws is None:
                draws = draw_candidates(n, n_order, k, seed, device)
            if not isinstance(draws, torch.Tensor):
                draws = torch.from_numpy(np.asarray(draws))
            draws = draws.to(device, torch.int64)
            if draws.shape != (max(n_order - 1, 0), k):
                raise ValueError(f"draws must be [{n_order - 1}, {k}], got {tuple(draws.shape)}")
            prefix = _farthest_point_sampled(normed, n_order, seed_idx, draws).cpu().numpy()
            _, first = np.unique(prefix, return_index=True)
            prefix = prefix[np.sort(first)]
    rest = np.setdiff1d(np.arange(n), prefix, assume_unique=False)
    return np.concatenate([prefix, rest])
