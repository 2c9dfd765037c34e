"""Lambda-gradient paths: the sort-free variants against the sorted
reference, the separable swap-delta factorisation, and the pairwise
conservation properties — across bucket shapes and paddings."""

import jax.numpy as jnp
import numpy as np
import pytest

from ranklib_tpu.gbdt.lambdas import (
    chunk_scale, lambda_weights, lambda_weights_nosort, separable_vectors,
)
from ranklib_tpu.metrics.base import create_scorer


def _case(B, D, seed, gmax=2):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, gmax + 1, size=(B, D)).astype(np.float32)
    scores = rng.normal(size=(B, D)).astype(np.float32)
    n = rng.integers(2, D + 1, size=B)
    mask = np.arange(D)[None, :] < n[:, None]
    labels[~mask] = 0.0
    return (jnp.asarray(labels), jnp.asarray(scores), jnp.asarray(mask))


@pytest.mark.parametrize("metric", ["NDCG@10", "NDCG@3", "DCG@5", "P@4"])
@pytest.mark.parametrize("B,D", [(4, 8), (3, 16), (2, 512), (2, 640)])
def test_nosort_matches_sorted_at_bucket_shapes(metric, B, D):
    """The sort-free separable path equals the sorted reference on the
    padding-bucket widths training uses, including the wide ones."""
    scorer = create_scorer(metric)
    labels, scores, mask = _case(B, D, seed=B * D + len(metric))
    want_lam, want_w = lambda_weights(scorer, labels, scores, mask)
    got_lam, got_w = lambda_weights_nosort(
        scorer, labels, scores, mask, chunk_scale(scorer, labels, mask))
    np.testing.assert_allclose(np.asarray(got_lam), np.asarray(want_lam),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got_w), np.asarray(want_w),
                               atol=2e-5, rtol=1e-4)


def test_nosort_wide_bucket():
    # D=1024: the widest padding bucket short of the long-list tail
    scorer = create_scorer("NDCG@10")
    labels, scores, mask = _case(2, 1024, seed=5)
    want = lambda_weights(scorer, labels, scores, mask)
    got = lambda_weights_nosort(scorer, labels, scores, mask,
                                chunk_scale(scorer, labels, mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   atol=5e-5, rtol=1e-4)


def test_separable_vectors_reproduce_swap_matrix():
    # |A_i − A_j|·|B_i − B_j| must equal |swap_deltas| on ranked labels
    scorer = create_scorer("NDCG@10")
    labels, scores, mask = _case(3, 16, seed=9)
    n = mask.sum(axis=-1).astype(jnp.int32)
    key = jnp.where(mask, -scores, jnp.inf)
    order = jnp.argsort(key, axis=-1, stable=True)
    L = jnp.take_along_axis(labels, order, axis=-1)
    A, Bv = separable_vectors(scorer, L, n)
    want = np.abs(np.asarray(scorer.swap_deltas(L, n)))
    got = (np.abs(np.asarray(A)[:, :, None] - np.asarray(A)[:, None, :])
           * np.abs(np.asarray(Bv)[:, :, None] - np.asarray(Bv)[:, None, :]))
    D = L.shape[1]
    valid = (np.arange(D)[None, :] < np.asarray(n)[:, None])
    pv = valid[:, :, None] & valid[:, None, :]
    np.testing.assert_allclose(got * pv, want, atol=1e-5)


def test_unseparable_metric_returns_none():
    scorer = create_scorer("ERR@10")
    L = jnp.zeros((2, 8))
    assert separable_vectors(scorer, L, jnp.array([8, 8])) is None


def test_lambda_antisymmetry_properties():
    """Pairwise lambda conservation (SURVEY §4 property tests): every pair
    adds +x to the winner and −x to the loser, so per-query lambdas sum to
    zero; weights are nonnegative; all-equal labels give zero lambdas."""
    import jax.numpy as jnp
    from ranklib_tpu.gbdt.lambdas import lambda_weights
    from ranklib_tpu.metrics.base import create_scorer

    rng = np.random.default_rng(4)
    scorer = create_scorer("NDCG@10")
    B, D = 6, 24
    labels = rng.integers(0, 5, size=(B, D)).astype(np.float32)
    scores = rng.normal(size=(B, D)).astype(np.float32)
    n = rng.integers(3, D + 1, size=B)
    mask = np.arange(D)[None, :] < n[:, None]
    labels[~mask] = 0

    lam, w = lambda_weights(scorer, jnp.asarray(labels), jnp.asarray(scores),
                            jnp.asarray(mask))
    lam = np.asarray(lam) * mask
    w = np.asarray(w) * mask
    np.testing.assert_allclose(lam.sum(axis=1), 0.0, atol=1e-4)
    assert (w >= -1e-6).all()

    flat = np.full((B, D), 2.0, np.float32)      # no orderable pairs
    flat[~mask] = 0
    lam2, _ = lambda_weights(scorer, jnp.asarray(flat), jnp.asarray(scores),
                             jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(lam2) * mask, 0.0, atol=1e-6)


@pytest.mark.parametrize("metric", ["NDCG@10", "NDCG@4", "DCG@5", "P@10"])
def test_nosort_lambda_matches_sorted_reference(metric):
    """The sort-free lambda path (stable compare-count ranks + closed-form
    position weights + per-fit ideal scale) must reproduce the sorted
    reference path, including score ties and padded docs."""
    from ranklib_tpu.gbdt.lambdas import (
        chunk_scale, lambda_weights, lambda_weights_nosort,
    )
    from ranklib_tpu.metrics.base import create_scorer

    scorer = create_scorer(metric)
    rng = np.random.default_rng(17)
    B, D = 7, 24
    labels = jnp.asarray(rng.integers(0, 5, size=(B, D)).astype(np.float32))
    # quantized scores force ties; one degenerate all-same-label row
    scores = jnp.asarray(
        np.round(rng.normal(size=(B, D)) * 4) / 4.0).astype(jnp.float32)
    labels = labels.at[3].set(2.0)
    n = rng.integers(3, D + 1, size=B)
    mask = jnp.asarray(np.arange(D)[None, :] < n[:, None])
    labels = jnp.where(mask, labels, 0.0)

    lam_ref, w_ref = lambda_weights(scorer, labels, scores, mask)
    scale = chunk_scale(scorer, labels, mask)
    lam, w = lambda_weights_nosort(scorer, labels, scores, mask, scale)
    np.testing.assert_allclose(np.asarray(lam), np.asarray(lam_ref),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(w), np.asarray(w_ref),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("metric", ["ERR@10", "ERR@3", "MAP"])
def test_nosort_err_map_lambda_matches_sorted_reference(metric):
    """The prefix-matvec sort-free paths for the non-separable metrics
    (ERR — the reference's default training metric — and MAP) must
    reproduce the sorted reference path, including score ties, padded
    docs, and an all-irrelevant query (MAP total=0)."""
    from ranklib_tpu.gbdt.lambdas import (
        lambda_weights, lambda_weights_nosort_err, lambda_weights_nosort_map,
    )
    from ranklib_tpu.metrics.base import create_scorer

    scorer = create_scorer(metric)
    fn = (lambda_weights_nosort_map if metric == "MAP"
          else lambda_weights_nosort_err)
    rng = np.random.default_rng(23)
    B, D = 7, 24
    labels = jnp.asarray(rng.integers(0, 5, size=(B, D)).astype(np.float32))
    scores = jnp.asarray(
        np.round(rng.normal(size=(B, D)) * 4) / 4.0).astype(jnp.float32)
    labels = labels.at[3].set(2.0)       # degenerate: no orderable pairs
    labels = labels.at[5].set(0.0)       # all-irrelevant (MAP total = 0)
    n = rng.integers(3, D + 1, size=B)
    mask = jnp.asarray(np.arange(D)[None, :] < n[:, None])
    labels = jnp.where(mask, labels, 0.0)

    lam_ref, w_ref = lambda_weights(scorer, labels, scores, mask)
    lam, w = fn(scorer, labels, scores, mask)
    np.testing.assert_allclose(np.asarray(lam), np.asarray(lam_ref),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(w), np.asarray(w_ref),
                               atol=1e-5, rtol=1e-4)


def test_nosort_err_label_above_gmax_stays_finite_and_matches():
    """A label above gmax (misconfigured -gmax) makes 1−R negative; the
    sorted path's cumprod stays finite and the sort-free path must track
    it (sign-parity form), not inject NaN."""
    from ranklib_tpu.gbdt.lambdas import (
        lambda_weights, lambda_weights_nosort_err,
    )
    from ranklib_tpu.metrics.base import MetricScorer

    scorer = MetricScorer("ERR", k=10, gmax=2.0)   # labels go to 4
    rng = np.random.default_rng(5)
    B, D = 4, 16
    labels = jnp.asarray(rng.integers(0, 5, size=(B, D)).astype(np.float32))
    scores = jnp.asarray(rng.normal(size=(B, D)).astype(np.float32))
    mask = jnp.asarray(np.ones((B, D), bool))

    lam_ref, w_ref = lambda_weights(scorer, labels, scores, mask)
    lam, w = lambda_weights_nosort_err(scorer, labels, scores, mask)
    assert np.isfinite(np.asarray(lam)).all()
    np.testing.assert_allclose(np.asarray(lam), np.asarray(lam_ref),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(w), np.asarray(w_ref),
                               atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("D,k", [(1, 1), (2, 3), (4, 10), (130, 1),
                                 (130, 200)])
def test_nosort_paths_fuzz_shapes_and_cutoffs(D, k):
    """All sort-free lambda paths × edge shapes: single-doc queries,
    k > D, wide buckets. Guards the rank/cutoff arithmetic (k_eff,
    compare-count ties, prefix matvecs) across the full routing table."""
    from ranklib_tpu.gbdt.lambdas import (
        chunk_scale, lambda_weights, lambda_weights_nosort,
        lambda_weights_nosort_err, lambda_weights_nosort_map,
    )
    from ranklib_tpu.metrics.base import create_scorer

    r = np.random.default_rng(D * 1000 + k)
    B = 5
    n = r.integers(1, D + 1, size=B)
    mask = np.arange(D)[None, :] < n[:, None]
    labels = (r.integers(0, 5, size=(B, D)) * mask).astype(np.float32)
    scores = (np.round(r.normal(size=(B, D)) * 2) / 2 * mask).astype(
        np.float32)
    L, S, M = jnp.asarray(labels), jnp.asarray(scores), jnp.asarray(mask)

    for metric in (f"NDCG@{k}", f"DCG@{k}", f"P@{k}", f"ERR@{k}", "MAP"):
        sc = create_scorer(metric)
        l0, w0 = lambda_weights(sc, L, S, M)
        if sc.metric in ("NDCG", "DCG", "P"):
            l1, w1 = lambda_weights_nosort(sc, L, S, M, chunk_scale(sc, L, M))
        elif sc.metric == "ERR":
            l1, w1 = lambda_weights_nosort_err(sc, L, S, M)
        else:
            l1, w1 = lambda_weights_nosort_map(sc, L, S, M)
        assert np.isfinite(np.asarray(l1)).all(), metric
        np.testing.assert_allclose(np.asarray(l1), np.asarray(l0),
                                   atol=1e-4, rtol=1e-4, err_msg=metric)
        np.testing.assert_allclose(np.asarray(w1), np.asarray(w0),
                                   atol=1e-4, rtol=1e-4, err_msg=metric)
