"""First-slice gate: Linear Regression + Coordinate Ascent,
NDCG@10 eval, model save/load round-trips, CLI flows."""

import numpy as np
import pytest

from ranklib_tpu.metrics.base import MetricScorer, score_dataset
from ranklib_tpu.models.base import load_ranker_file
from ranklib_tpu.models.coorascent import CoorAscent
from ranklib_tpu.models.linear import LinearRegRank

from fixtures import synth_dataset, write_letor_text

SCORER = MetricScorer("NDCG", 10)


@pytest.fixture(scope="module")
def ds():
    return synth_dataset(n_queries=25, n_features=8, min_docs=5, max_docs=25,
                         seed=11, signal=3.0)


@pytest.fixture(scope="module")
def ds_test():
    return synth_dataset(n_queries=10, n_features=8, min_docs=5, max_docs=25,
                         seed=99, signal=3.0, w_seed=11)


def random_ndcg(d):
    rng = np.random.default_rng(0)
    scores = [rng.normal(size=q.n) for q in d.queries]
    return score_dataset(SCORER, d, scores)[0]


def test_linear_regression_learns(ds, ds_test):
    r = LinearRegRank()
    r.fit(ds, SCORER)
    m_train = r.score_metric(ds, SCORER)
    m_test = r.score_metric(ds_test, SCORER)
    base = random_ndcg(ds_test)
    assert m_train > 0.85  # planted linear signal must be recovered
    assert m_test > base + 0.15


def test_linear_exact_fit():
    """Labels exactly linear in features → near-perfect ranking."""
    d = synth_dataset(n_queries=10, n_features=5, seed=3)
    w = np.arange(1, 6, dtype=np.float64)
    for q in d.queries:
        # global affine target → intercept absorbs the +10 shift
        q.labels = (q.feats @ w + 10.0).astype(np.float32)
    r = LinearRegRank()
    r.fit(d, None)
    np.testing.assert_allclose(r.weights[1:], w, rtol=1e-4)


def test_linear_save_load_roundtrip(ds, tmp_path):
    r = LinearRegRank()
    r.fit(ds, None)
    p = tmp_path / "lr.txt"
    r.save(str(p))
    r2 = load_ranker_file(str(p))
    assert isinstance(r2, LinearRegRank)
    np.testing.assert_allclose(r2.weights, r.weights, rtol=1e-12)
    for a, b in zip(r.eval_dataset(ds), r2.eval_dataset(ds)):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_coorascent_learns(ds, ds_test):
    r = CoorAscent(n_restart=2, max_passes=4)
    r.fit(ds, SCORER)
    assert abs(np.abs(r.weights).sum() - 1.0) < 1e-9  # Σ|w| = 1 invariant
    m_train = r.score_metric(ds, SCORER)
    m_test = r.score_metric(ds_test, SCORER)
    assert m_train > 0.85
    assert m_test > random_ndcg(ds_test) + 0.15


def test_coorascent_beats_uniform_start(ds):
    r = CoorAscent(n_restart=1, max_passes=3)
    ev_metric_uniform = None
    from ranklib_tpu.ops.batched_eval import LinearMetricEvaluator
    ev = LinearMetricEvaluator(ds, SCORER)
    w0 = np.full(ds.n_features, 1.0 / ds.n_features)
    ev_metric_uniform = float(ev.mean_metric(w0[:, None])[0])
    r.fit(ds, SCORER)
    assert r.score_metric(ds, SCORER) >= ev_metric_uniform


def test_coorascent_save_load(ds, tmp_path):
    r = CoorAscent(n_restart=1, max_passes=2)
    r.fit(ds, SCORER)
    p = tmp_path / "ca.txt"
    r.save(str(p))
    r2 = load_ranker_file(str(p))
    assert isinstance(r2, CoorAscent)
    np.testing.assert_allclose(r2.weights, r.weights, rtol=1e-12)


def test_cli_train_test_save_load_rank(tmp_path):
    from ranklib_tpu.cli import main

    train = synth_dataset(n_queries=15, n_features=6, seed=21, signal=3.0)
    test = synth_dataset(n_queries=6, n_features=6, seed=22, signal=3.0)
    trainf, testf = tmp_path / "train.txt", tmp_path / "test.txt"
    write_letor_text(train, trainf)
    write_letor_text(test, testf)
    model = tmp_path / "model.txt"

    # train+test+save (linear regression for speed)
    rc = main(["-train", str(trainf), "-ranker", "9", "-metric2t", "NDCG@10",
               "-test", str(testf), "-save", str(model), "-silent"])
    assert rc == 0 and model.exists()
    head = model.read_text().splitlines()[0]
    assert head == "## Linear Regression"

    # load + test with -idv
    idv = tmp_path / "idv.txt"
    rc = main(["-load", str(model), "-test", str(testf),
               "-metric2T", "NDCG@10", "-idv", str(idv), "-silent"])
    assert rc == 0
    lines = idv.read_text().splitlines()
    assert len(lines) == len(test.queries) + 1
    assert lines[0].startswith("NDCG@10   ")
    assert lines[-1].split()[1] == "all"

    # load + rank + score file
    scoref = tmp_path / "scores.txt"
    rc = main(["-load", str(model), "-rank", str(testf),
               "-score", str(scoref), "-silent"])
    assert rc == 0
    rows = [l.split("\t") for l in scoref.read_text().splitlines()]
    assert len(rows) == test.n_docs
    assert rows[0][0] == test.queries[0].qid


def test_cli_kcv(tmp_path):
    from ranklib_tpu.cli import main

    train = synth_dataset(n_queries=12, n_features=5, seed=31, signal=3.0)
    trainf = tmp_path / "train.txt"
    write_letor_text(train, trainf)
    md = tmp_path / "models"
    rc = main(["-train", str(trainf), "-ranker", "9", "-metric2t", "NDCG@10",
               "-kcv", "3", "-kcvmd", str(md), "-kcvmn", "lr", "-silent"])
    assert rc == 0
    import os
    assert sorted(os.listdir(md)) == ["f1.lr", "f2.lr", "f3.lr"]


def test_cli_norm_and_feature_subset(tmp_path):
    from ranklib_tpu.cli import main

    train = synth_dataset(n_queries=10, n_features=6, seed=41, signal=3.0)
    trainf = tmp_path / "train.txt"
    write_letor_text(train, trainf)
    feat = tmp_path / "feats.txt"
    feat.write_text("1\n2\n3\n# comment\n4\n")
    model = tmp_path / "m.txt"
    rc = main(["-train", str(trainf), "-ranker", "9", "-metric2t", "NDCG@10",
               "-norm", "zscore", "-feature", str(feat), "-save", str(model),
               "-silent"])
    assert rc == 0
