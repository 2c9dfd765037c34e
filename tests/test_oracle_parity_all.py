"""Engine vs independent-oracle parity for the non-GBDT rankers
(rankers other than the GBDT family).

`tools/oracle.py` re-derives every training algorithm in pure numpy
float64 straight from the reference semantics (per-pair/per-query loops,
explicit pair distributions, hand-written backprop — no autodiff, no
shared code with ranklib_tpu). These tests pin the fused array-shaped
engines against it for `-ranker` 1, 2, 3, 4, 5, 7, 8, 9 — together with
tests/test_oracle_parity.py (rankers 0 and 6) every training semantic in
the CLI surface is engine-vs-oracle pinned.

Reference anchors: learning/boosting/RankBoost.java:~30,
learning/boosting/AdaRank.java:~30, learning/CoorAscent.java:~100,
learning/neuralnet/RankNet.java:~250, learning/LinearRegRank.java:~120,
learning/tree/RFRanker.java:~25.
"""

import jax
import numpy as np
import pytest

from ranklib_tpu.data.dataset import bucketize, flatten
from ranklib_tpu.data.sampling import sample_features, sample_queries
from ranklib_tpu.metrics.base import create_scorer
from ranklib_tpu.models.adarank import AdaRank
from ranklib_tpu.models.coorascent import CoorAscent
from ranklib_tpu.models.linear import LinearRegRank
from ranklib_tpu.models.neural import LambdaRank, ListNet, RankNet, _init_params
from ranklib_tpu.models.rankboost import RankBoost
from ranklib_tpu.models.rf import RFRanker
from tests.fixtures import synth_dataset
from tools import oracle as orc


# --------------------------------------------------------------- RankBoost


def _rb_pair(ds, scorer, rounds=15, tc=8, val=None):
    eng = RankBoost(n_rounds=rounds, n_threshold=tc)
    eng.fit(ds, scorer, validation=val)
    o = orc.OracleRankBoost(n_rounds=rounds, n_threshold=tc,
                            metric=scorer.metric, k=scorer.k,
                            gmax=scorer.gmax)
    o.fit(orc.dataset_to_oracle(ds),
          orc.dataset_to_oracle(val) if val is not None else None)
    return eng, o


def _assert_weaks_equal(eng, o, atol_alpha=3e-4):
    assert len(eng.weaks) == len(o.weaks), (eng.weaks, o.weaks)
    for t, ((fe, te, ae), (fo, to, ao)) in enumerate(zip(eng.weaks, o.weaks)):
        assert fe == fo, f"round {t}: feature {fe} vs {fo}"
        np.testing.assert_allclose(te, to, atol=1e-6, err_msg=f"round {t} θ")
        np.testing.assert_allclose(ae, ao, atol=atol_alpha,
                                   err_msg=f"round {t} α")


def test_rankboost_oracle_parity():
    ds = synth_dataset(n_queries=10, n_features=6, min_docs=4, max_docs=12,
                       gmax=2, seed=41)
    eng, o = _rb_pair(ds, create_scorer("NDCG@10"))
    _assert_weaks_equal(eng, o)
    # prediction stacks agree on held-out data
    test = synth_dataset(n_queries=4, n_features=6, min_docs=4, max_docs=10,
                         gmax=2, seed=42, w_seed=41)
    eng_scores = eng.eval_dataset(test)
    for q, es in zip(orc.dataset_to_oracle(test), eng_scores):
        np.testing.assert_allclose(es, o.predict_query(q), atol=1e-4)


def test_rankboost_oracle_parity_validation_truncation():
    ds = synth_dataset(n_queries=10, n_features=5, min_docs=4, max_docs=10,
                       gmax=2, seed=51)
    val = synth_dataset(n_queries=5, n_features=5, min_docs=4, max_docs=10,
                        gmax=2, seed=52, w_seed=51)
    eng, o = _rb_pair(ds, create_scorer("ERR@10"), rounds=12, val=val)
    _assert_weaks_equal(eng, o)


# ----------------------------------------------------------------- AdaRank


def _ada_pair(ds, scorer, rounds=25, val=None, **hp):
    eng = AdaRank(n_rounds=rounds, **hp)
    eng.fit(ds, scorer, validation=val)
    o = orc.OracleAdaRank(n_rounds=rounds, metric=scorer.metric, k=scorer.k,
                          gmax=scorer.gmax,
                          no_eq=hp.get("no_eq", False),
                          max_sel_count=hp.get("max_sel_count", 5),
                          tolerance=hp.get("tolerance", 0.002))
    o.fit(orc.dataset_to_oracle(ds),
          orc.dataset_to_oracle(val) if val is not None else None)
    return eng, o


def _assert_history_equal(eng, o, atol_alpha=3e-4):
    assert len(eng.history) == len(o.history), (eng.history, o.history)
    for t, ((fe, ae), (fo, ao)) in enumerate(zip(eng.history, o.history)):
        assert fe == fo, f"round {t}: feature {fe} vs {fo}"
        np.testing.assert_allclose(ae, ao, atol=atol_alpha,
                                   err_msg=f"round {t} α")
    np.testing.assert_allclose(eng.weights, o.weights, atol=5e-4)


def test_adarank_oracle_parity():
    ds = synth_dataset(n_queries=12, n_features=8, min_docs=5, max_docs=14,
                       gmax=2, seed=61)
    eng, o = _ada_pair(ds, create_scorer("NDCG@10"))
    _assert_history_equal(eng, o)


def test_adarank_oracle_parity_noeq_and_validation():
    ds = synth_dataset(n_queries=12, n_features=8, min_docs=5, max_docs=14,
                       gmax=2, seed=71)
    val = synth_dataset(n_queries=6, n_features=8, min_docs=5, max_docs=14,
                        gmax=2, seed=72, w_seed=71)
    eng, o = _ada_pair(ds, create_scorer("MAP"), val=val, no_eq=True,
                       tolerance=0.0005)
    _assert_history_equal(eng, o)


# ------------------------------------------------------- Coordinate Ascent


def test_coorascent_oracle_parity():
    ds = synth_dataset(n_queries=10, n_features=5, min_docs=5, max_docs=12,
                       gmax=2, seed=81)
    scorer = create_scorer("NDCG@10")
    eng = CoorAscent(n_restart=2, n_max_iteration=10, max_passes=6, seed=3)
    eng.fit(ds, scorer)
    o = orc.OracleCoorAscent(n_restart=2, depth=10, max_passes=6, seed=3,
                             metric=scorer.metric, k=scorer.k,
                             gmax=scorer.gmax)
    o.fit(orc.dataset_to_oracle(ds))
    np.testing.assert_allclose(eng.weights, o.weights, atol=2e-3)
    # both stacks agree on the quality of the final model
    from ranklib_tpu.metrics.base import score_dataset
    m_eng = score_dataset(scorer, ds, eng.eval_dataset(ds))[0]
    assert abs(m_eng - o.best_metric) < 1e-3


def test_coorascent_oracle_parity_reg():
    ds = synth_dataset(n_queries=8, n_features=4, min_docs=5, max_docs=10,
                       gmax=2, seed=91)
    scorer = create_scorer("P@5")
    eng = CoorAscent(n_restart=1, n_max_iteration=8, max_passes=4, seed=0,
                     reg=0.01)
    eng.fit(ds, scorer)
    o = orc.OracleCoorAscent(n_restart=1, depth=8, max_passes=4, seed=0,
                             reg=0.01, metric=scorer.metric, k=scorer.k,
                             gmax=scorer.gmax)
    o.fit(orc.dataset_to_oracle(ds))
    np.testing.assert_allclose(eng.weights, o.weights, atol=2e-3)


# ------------------------------------------------------------------ Neural


def _engine_visit_order(ds):
    """The fused epoch step scans buckets smallest-D first, file order
    inside each bucket — the oracle must take its per-query SGD steps in
    exactly that order."""
    return [int(qi) for b in bucketize(ds) for qi in b.qidx]


def _neural_pair(cls, loss, ds, scorer, epochs, lr, val=None, **hp):
    eng = cls(n_epoch=epochs, learning_rate=lr, **hp)
    eng.fit(ds, scorer, validation=val)
    sizes = eng._layer_sizes(ds.n_features)
    params0 = [(np.asarray(W, np.float64), np.asarray(b, np.float64))
               for W, b in _init_params(jax.random.PRNGKey(eng.seed), sizes)]
    o = orc.OracleNeuralRanker(params=params0, loss=loss, lr=lr,
                               n_epoch=epochs, metric=scorer.metric,
                               k=scorer.k, gmax=scorer.gmax)
    qs = orc.dataset_to_oracle(ds)
    ordered = [qs[i] for i in _engine_visit_order(ds)]
    o.fit(ordered, orc.dataset_to_oracle(val) if val is not None else None)
    return eng, o


def _assert_params_close(eng, o, atol):
    assert len(eng.params) == len(o.params)
    for (We, be), (Wo, bo) in zip(eng.params, o.params):
        np.testing.assert_allclose(We, Wo, atol=atol)
        np.testing.assert_allclose(be, bo, atol=atol)


def test_ranknet_oracle_parity():
    ds = synth_dataset(n_queries=8, n_features=6, min_docs=4, max_docs=12,
                       gmax=2, seed=101)
    eng, o = _neural_pair(RankNet, "ranknet", ds, create_scorer("NDCG@10"),
                          epochs=3, lr=0.001)
    _assert_params_close(eng, o, atol=5e-5)
    test = synth_dataset(n_queries=3, n_features=6, min_docs=4, max_docs=10,
                         gmax=2, seed=102, w_seed=101)
    for q, es in zip(orc.dataset_to_oracle(test), eng.eval_dataset(test)):
        np.testing.assert_allclose(es, o.predict_query(q), atol=1e-5)


def test_lambdarank_oracle_parity():
    ds = synth_dataset(n_queries=8, n_features=6, min_docs=4, max_docs=12,
                       gmax=2, seed=111)
    eng, o = _neural_pair(LambdaRank, "lambdarank", ds,
                          create_scorer("NDCG@10"), epochs=3, lr=0.001)
    _assert_params_close(eng, o, atol=5e-5)


def test_listnet_oracle_parity():
    ds = synth_dataset(n_queries=8, n_features=6, min_docs=4, max_docs=12,
                       gmax=2, seed=121)
    eng, o = _neural_pair(ListNet, "listnet", ds, create_scorer("NDCG@10"),
                          epochs=5, lr=0.01)
    assert eng._layer_sizes(ds.n_features) == [6, 1]   # linear scorer
    _assert_params_close(eng, o, atol=5e-5)


def test_ranknet_validation_snapshot_parity():
    """Best-on-validation weight snapshot (ref: RankNet.
    saveBestModelOnValidation): both stacks restore the same epoch."""
    ds = synth_dataset(n_queries=8, n_features=5, min_docs=4, max_docs=10,
                       gmax=2, seed=131)
    val = synth_dataset(n_queries=4, n_features=5, min_docs=4, max_docs=10,
                        gmax=2, seed=132, w_seed=131)
    eng, o = _neural_pair(RankNet, "ranknet", ds, create_scorer("NDCG@10"),
                          epochs=5, lr=0.05, val=val)
    _assert_params_close(eng, o, atol=5e-4)


# ------------------------------------------------------------------ Linear


def test_linear_oracle_parity():
    ds = synth_dataset(n_queries=10, n_features=7, min_docs=5, max_docs=12,
                       gmax=2, seed=141)
    eng = LinearRegRank()
    eng.fit(ds)
    w_o = orc.linear_reg_oracle(orc.dataset_to_oracle(ds))
    np.testing.assert_allclose(eng.weights, w_o, atol=1e-8)


# --------------------------------------------------------------------- RF


def test_rf_bag_oracle_parity():
    """Every bag's trees match an oracle MART grown on the bag's
    materialized resample (queries repeated per multiplicity, global
    thresholds, feature mask) — pins rng consumption order, weighted
    with-replacement sampling, feature bagging, and mean-residual leaf
    outputs at once (ref: learning/tree/RFRanker.java:~25)."""
    ds = synth_dataset(n_queries=10, n_features=6, min_docs=5, max_docs=12,
                       gmax=2, seed=151)
    scorer = create_scorer("NDCG@10")
    eng = RFRanker(n_bags=3, n_trees=2, n_leaves=4, seed=7,
                   feature_sampling_rate=0.5, n_threshold=16)
    eng.fit(ds, scorer)
    assert len(eng.ensembles) == 3

    feats, _, _ = flatten(ds)
    thr_o = orc.compute_thresholds_oracle(feats, 16)
    F = ds.n_features
    rng = np.random.default_rng(7)               # engine's bag rng stream
    from tests.test_oracle_parity import _tree_equal

    for bag in range(3):
        _, _, qidx = sample_queries(ds, 1.0, rng)
        fids = sample_features(F, 0.5, rng)
        fmask = np.zeros(F, bool)
        fmask[[f - 1 for f in fids]] = True
        bag_queries = [orc.dataset_to_oracle(ds)[i] for i in qidx]
        o = orc.OracleLambdaMART(
            n_trees=2, n_leaves=4, learning_rate=0.1, n_threshold=16,
            min_leaf_support=1.0, early_stop=0, metric="NDCG", k=10,
            pointwise=True, newton=False)
        o.fit(bag_queries, feature_mask=fmask, thresholds=thr_o)
        ens = eng.ensembles[bag]
        assert len(ens.trees) == len(o.trees)
        for te, to in zip(ens.trees, o.trees):
            _tree_equal(te, to, thr_o)


def test_ranknet_two_hidden_layers_oracle_parity():
    """Multi-layer backprop parity (-layer 2): the oracle's hand-derived
    chain rule vs the engine's autodiff through stacked sigmoid layers."""
    ds = synth_dataset(n_queries=6, n_features=5, min_docs=4, max_docs=10,
                       gmax=2, seed=161)
    eng, o = _neural_pair(RankNet, "ranknet", ds, create_scorer("NDCG@10"),
                          epochs=3, lr=0.01, n_layers=2,
                          n_hidden_per_layer=6)
    assert eng._layer_sizes(ds.n_features) == [5, 6, 6, 1]
    _assert_params_close(eng, o, atol=5e-5)
