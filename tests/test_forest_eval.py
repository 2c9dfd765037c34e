"""Ensemble scoring: the Triton kernel and the XLA scan vs traversal.

On the CPU the kernel runs in Pallas interpret mode; compiled for the GPU
the same comparison runs in ``chip_smoke.py``'s kernel phase. The
pointer-chasing ``_ensemble_eval`` is the reference (itself pinned against
the oracle in test_gbdt.py); ``_mm_eval`` is the XLA path.
"""

import copy
import functools

import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as g
from ranklib_tpu.gbdt.ensemble import TreeEnsemble, _ensemble_eval, _mm_eval
from ranklib_tpu.ops import forest_eval, routing
from ranklib_tpu.ops.forest_eval import forest_eval_triton


def _case(n_trees, n_leaves, n_features, n_docs, seed):
    rng = np.random.default_rng(seed)
    ens = g._synthetic_ensemble(n_trees=n_trees, n_leaves=n_leaves,
                                n_features=n_features, rng=rng)
    X = jnp.asarray(rng.normal(size=(n_docs, n_features)).astype(np.float32))
    packed = ens._pack_matmul(n_features)
    return ens, X, packed


def _traverse(ens, X):
    fe, th, lf, rt, lv, ot, wt, depth = ens._pack()
    return np.asarray(_ensemble_eval(jnp.asarray(X), fe, th, lf, rt, lv, ot,
                                     wt, depth=depth))


def _kernel(ens, X):
    return np.asarray(forest_eval_triton(jnp.asarray(X), *ens._pack_kernel(),
                                         interpret=True))


def _boundary_docs(ens, F, n, seed):
    """Docs whose feature values ARE the model's split thresholds."""
    rng = np.random.default_rng(seed)
    thrs = np.concatenate([t.threshold[~t.is_leaf] for t in ens.trees])
    X = rng.normal(size=(n, F)).astype(np.float32)
    flat = X.reshape(-1)
    pick = rng.integers(0, len(thrs), size=len(flat) // 2)
    flat[: len(pick)] = thrs[pick]
    return flat.reshape(n, F)


def _grid256_model(seed):
    """Every split on feature 0, 256 distinct thresholds."""
    rng = np.random.default_rng(seed)
    ens = g._synthetic_ensemble(n_trees=60, n_leaves=6, n_features=12,
                                rng=rng)
    pool = np.linspace(-2.0, 2.0, 256).astype(np.float32)
    i = 0
    for t in ens.trees:
        for n in np.flatnonzero(~t.is_leaf):
            t.feature[n] = 0
            t.threshold[n] = pool[i % 256]
            i += 1
    X = rng.normal(size=(400, 12)).astype(np.float32)
    X[7, 0] = 5.0                        # above every threshold
    X[11, 0] = np.nan                    # NaN routes right
    X[13, 0] = pool[17]                  # exactly on a threshold
    return ens, X


def _inf_nan_case():
    ens, X, _ = _case(23, 7, 13, 64, seed=2)
    Xn = np.asarray(X).copy()
    Xn[3, 5] = -np.inf
    Xn[7, 1] = np.inf
    Xn[9, 0] = np.nan
    return ens, Xn


def _named_case(name):
    if name == "odd":
        ens, X, _ = _case(23, 7, 13, 257, seed=11)
        return ens, np.asarray(X)
    if name == "boundary":
        ens, _, _ = _case(23, 7, 13, 8, seed=11)
        return ens, _boundary_docs(ens, 13, 512, seed=13)
    if name == "inf_nan":
        return _inf_nan_case()
    return _grid256_model(seed=5)


def test_full_kernel_matches_xla_scan():
    ens, X, packed = _case(50, 10, 20, 300, seed=7)
    want = np.asarray(_mm_eval(X, *packed))
    got = _kernel(ens, X)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_full_kernel_odd_shapes():
    # trees not a multiple of the chunk, odd leaves/features/docs
    ens, X, packed = _case(23, 7, 13, 257, seed=11)
    want = np.asarray(_mm_eval(X, *packed))
    got = _kernel(ens, X)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_kernel_matches_traversal():
    ens, X, _ = _case(50, 10, 20, 300, seed=7)
    np.testing.assert_allclose(_kernel(ens, X), _traverse(ens, X),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["odd", "boundary", "inf_nan", "grid256"])
def test_mm_eval_matches_traversal(name):
    """The XLA path on the cases the kernels must get right: odd shapes,
    docs exactly on split thresholds, ±inf/NaN features, and a feature
    with 256 distinct thresholds."""
    ens, X = _named_case(name)
    got = np.asarray(_mm_eval(jnp.asarray(X), *ens._pack_matmul(X.shape[1])))
    np.testing.assert_allclose(got, _traverse(ens, X), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["odd", "boundary", "inf_nan", "grid256"])
def test_kernel_cases_match_traversal(name):
    ens, X = _named_case(name)
    np.testing.assert_allclose(_kernel(ens, X), _traverse(ens, X),
                               atol=1e-5, rtol=1e-5)


def test_eval_matrix_kernel_route(monkeypatch):
    # force the kernel route (interpret mode) through the real eval_matrix
    # entry, including the chunked path and a ragged tail
    ens, X, packed = _case(37, 7, 12, 600, seed=3)
    Xn = np.asarray(X)
    want = ens.eval_matrix(Xn)                    # XLA route on CPU
    monkeypatch.setattr(routing, "scoring_kernel", lambda M, L: True)
    monkeypatch.setattr(forest_eval, "forest_eval_triton", functools.partial(
        forest_eval_triton, interpret=True))
    monkeypatch.setattr(TreeEnsemble, "_EVAL_CHUNK_KERNEL", 256)
    got = ens.eval_matrix(Xn)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_eval_matrix_chunked_tail(monkeypatch):
    """XLA route with several chunks and a ragged tail == one call."""
    ens, X, packed = _case(30, 6, 9, 1000, seed=4)
    want = np.asarray(_mm_eval(X, *packed))
    monkeypatch.setattr(TreeEnsemble, "_EVAL_CHUNK", 300)
    np.testing.assert_allclose(ens.eval_matrix(np.asarray(X)), want,
                               atol=1e-6, rtol=1e-6)


def test_route_rejects_wide_trees(monkeypatch):
    """A -leaf 500 model is wider than one kernel chunk: it scores
    through _mm_eval even on the GPU; a 10-leaf model takes the kernel."""
    monkeypatch.setattr(routing, "platform", lambda: "gpu")
    rng = np.random.default_rng(0)
    big = g._synthetic_ensemble(n_trees=3, n_leaves=500, n_features=20,
                                rng=rng)
    fn, chunk = big._device_eval_fn(20)
    assert chunk == TreeEnsemble._EVAL_CHUNK
    ok = g._synthetic_ensemble(n_trees=3, n_leaves=10, n_features=20,
                               rng=rng)
    fn, chunk = ok._device_eval_fn(20)
    assert chunk == TreeEnsemble._EVAL_CHUNK_KERNEL


def test_kernel_pack_layout():
    """Chunks of 64 // max(M, L) trees, power-of-two widths ≥ 16, pad
    leaves unmatched (−1), one nonzero ±1 per path edge."""
    ens, _, _ = _case(23, 7, 13, 8, seed=11)
    fid, thr, pmq, nleft, outw = ens._pack_kernel()
    M, L = ens._tree_dims()
    TC = 64 // max(M, L)
    assert fid.shape == (-(-23 // TC), 64) and pmq.shape[1:] == (64, 64)
    assert pmq.dtype == jnp.bfloat16
    nl = np.asarray(nleft)
    assert (nl[:, TC * L:] == -1).all()
    p = np.asarray(pmq, np.float32)
    assert set(np.unique(p)) <= {-1.0, 0.0, 1.0}
    # a real leaf's left-edge count equals its +1 entries; the last
    # chunk's missing trees are pad leaves like the lane padding
    assert (nl >= 0).sum() == sum(t.is_leaf.sum() for t in ens.trees)
    np.testing.assert_array_equal(
        np.where(nl >= 0, (p == 1).sum(axis=1), -1), nl)


def test_pack_invalidated_by_add():
    ens, X, _ = _case(5, 6, 20, 64, seed=9)
    before = _kernel(ens, X)
    bt = copy.deepcopy(ens.trees[0])
    ens.add(bt, 1.0)
    after = _kernel(ens, X)
    np.testing.assert_allclose(after, _traverse(ens, X), atol=1e-5,
                               rtol=1e-5)
    assert not np.allclose(before, after)


def test_full_kernel_inf_features_route_like_f32():
    """±inf features compare like the f32 traversal (−inf LEFT, +inf
    right), NaN fails every compare and routes right."""
    ens, Xn = _inf_nan_case()
    want = np.asarray(_mm_eval(jnp.asarray(Xn), *ens._pack_matmul(13)))
    got = _kernel(ens, Xn)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
