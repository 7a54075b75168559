"""The port's farthest-point order (``ops/diversity.py``) against the JAX
package's, on the CPU.

The exact order must equal JAX's pick for pick. The products' float32 sums
run in another order in XLA and in torch, so where two rows' ``maxsim``
differ by about an ulp the pick can flip; each case's seeded data is
therefore asserted to keep the smallest and second-smallest ``maxsim``
(replayed in float64 along JAX's picks) more than 1e-5 apart at every step.
The sampled order cannot draw JAX's threefry candidates; it is held to JAX's
order when handed JAX's draws (replayed here with the same key splits), and
its own draws to their contract: each pick is the argmin over its draws,
and a seed gives the same order twice."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_assisted_data_labeling_tpu.ops import diversity as jdiv
from clip_assisted_data_labeling_tpu_torch.ops import diversity as tdiv
from clip_assisted_data_labeling_tpu_torch.ops.similarity import normalize_rows
from clip_assisted_data_labeling_tpu_torch.utils.timer import StageTimer

GAP = 1e-5


def _embeddings(n, width, seed, rank=None):
    """Seeded rows; with ``rank`` they lie near a ``rank``-dimensional
    subspace of the full width, which spreads the cosines (at width 768
    independent rows keep the smallest maxsims within 1e-5 of each other)."""
    rng = np.random.default_rng(seed)
    if rank is None:
        return rng.normal(size=(n, width)).astype(np.float32)
    basis, _ = np.linalg.qr(rng.normal(size=(width, rank)))
    z = rng.normal(size=(n, rank)) @ basis.T + 1e-3 * rng.normal(size=(n, width))
    return z.astype(np.float32)


def _smallest_gaps(emb, prefix, draws=None):
    """Along ``prefix``'s picks, replayed in float64: at each step the gap
    between the smallest and the second-smallest finite maxsim among the
    candidates (every row, or the step's distinct draws)."""
    x = normalize_rows(emb).astype(np.float64)
    maxsim = x @ x[prefix[0]]
    maxsim[prefix[0]] = np.inf
    gaps = []
    for i, p in enumerate(prefix[1:]):
        cand = np.arange(len(x)) if draws is None else np.unique(draws[i])
        vals = np.sort(maxsim[cand])
        vals = vals[np.isfinite(vals)]
        if len(vals) >= 2:
            gaps.append(vals[1] - vals[0])
        maxsim = np.maximum(maxsim, x @ x[p])
        maxsim[p] = np.inf
    return np.asarray(gaps)


def _jax_draws(n, n_order, candidates, seed):
    """The candidates JAX's sampled loop draws: step i splits the carried
    key and draws ``candidates`` indices from the new subkey."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(1, n_order):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (candidates,), 0, n)))
    return np.stack(out) if out else np.zeros((0, candidates), np.int64)


@pytest.mark.parametrize("n, width, n_order, seed_idx, seed, rank", [
    (512, 64, 100, 0, 7, None),
    (2048, 64, 64, 5, 0, None),
    (2048, 768, 100, 3, 7, 6),
    (1024, 768, 120, 3, 3, 5),
    (40, 64, 40, 7, 0, 3),
])
def test_exact_order_matches_jax(n, width, n_order, seed_idx, seed, rank):
    emb = _embeddings(n, width, seed, rank)
    want = np.asarray(jdiv.farthest_point_order(emb, n_order=n_order, seed_idx=seed_idx))
    gaps = _smallest_gaps(emb, want[:n_order])
    assert gaps.min() > GAP, f"seeded data too close to a tie: gap {gaps.min():.3g}"
    got = tdiv.farthest_point_order(emb, n_order=n_order, seed_idx=seed_idx, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == n


@pytest.mark.parametrize("n, width, n_order, candidates, seed", [
    (512, 64, 120, 100, 0),
    (2048, 768, 60, 16, 1),
    (12, 64, 12, 3, 0),  # draws run out: repeated picks are dropped
])
def test_sampled_order_matches_jax_given_its_draws(n, width, n_order, candidates, seed):
    emb = _embeddings(n, width, seed)
    k = min(candidates, n)
    draws = _jax_draws(n, n_order, k, seed)
    raw = np.asarray(jdiv._farthest_point_sampled(
        jnp.asarray(normalize_rows(emb)), n_order, 0, k, jax.random.PRNGKey(seed)))
    gaps = _smallest_gaps(emb, raw, draws)
    assert len(gaps) == 0 or gaps.min() > GAP, f"draws too close to a tie: {gaps.min():.3g}"
    want = np.asarray(jdiv.farthest_point_order(emb, n_order=n_order, candidates=candidates,
                                                seed=seed))
    got = tdiv.farthest_point_order(emb, n_order=n_order, candidates=candidates,
                                    draws=draws, device="cpu")
    np.testing.assert_array_equal(got, want)
    if n_order == n:  # the exhausted case really repeated a pick
        assert len(np.unique(raw)) < n_order


def test_own_draws_pick_argmins_and_repeat_by_seed():
    n, n_order, k = 1500, 80, 100
    emb = _embeddings(n, 64, 11)
    timer = StageTimer()
    order = tdiv.farthest_point_order(emb, n_order=n_order, candidates=k, seed=5,
                                      device="cpu", timer=timer)
    assert set(timer.totals) == {"prepare", "order"}
    np.testing.assert_array_equal(
        order, tdiv.farthest_point_order(emb, n_order=n_order, candidates=k, seed=5,
                                         device="cpu"))
    assert not np.array_equal(
        order, tdiv.farthest_point_order(emb, n_order=n_order, candidates=k, seed=6,
                                         device="cpu"))
    draws = tdiv.draw_candidates(n, n_order, k, 5, "cpu").numpy()
    assert draws.shape == (n_order - 1, k) and draws.min() >= 0 and draws.max() < n
    x = normalize_rows(emb).astype(np.float64)
    maxsim = x @ x[order[0]]
    maxsim[order[0]] = np.inf
    for i, p in enumerate(order[1:n_order]):
        assert p in draws[i]
        assert maxsim[p] <= maxsim[draws[i]].min() + GAP
        maxsim = np.maximum(maxsim, x @ x[p])
        maxsim[p] = np.inf
    np.testing.assert_array_equal(np.sort(order), np.arange(n))


def test_prefix_clamps_and_tail_keeps_the_original_order():
    emb = _embeddings(30, 16, 2)
    order = tdiv.farthest_point_order(emb, n_order=10, seed_idx=4, device="cpu")
    prefix, tail = order[:10], order[10:]
    assert prefix[0] == 4 and len(set(prefix.tolist())) == 10
    np.testing.assert_array_equal(tail, np.setdiff1d(np.arange(30), prefix))
    full = tdiv.farthest_point_order(emb, n_order=500, device="cpu")
    np.testing.assert_array_equal(np.sort(full), np.arange(30))
    with pytest.raises(ValueError, match="draws"):
        tdiv.farthest_point_order(emb, n_order=10, candidates=4,
                                  draws=np.zeros((3, 4), np.int64), device="cpu")


def test_diversity_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        tdiv.farthest_point_order(_embeddings(8, 4, 0))
