"""GBDT engine tests: binning, tree growth golden cases, MART/LambdaMART
end-to-end quality, model round-trip, RankLib-format interop.

Mirrors the reference's de-facto test protocol (SURVEY.md §4): tiny inline
fixtures, train→save→load→score round-trips, hand-computed golden values.
"""

import numpy as np
import pytest

from ranklib_tpu.data.dataset import Dataset, Query
from ranklib_tpu.gbdt.binning import bin_features, compute_thresholds
from ranklib_tpu.gbdt.ensemble import Tree, TreeEnsemble
from ranklib_tpu.gbdt.grow import grow_tree, leaf_outputs
from ranklib_tpu.metrics.base import create_scorer
from ranklib_tpu.models.base import load_ranker_file
from ranklib_tpu.models.gbdt import MART, LambdaMART
from tests.fixtures import synth_dataset


# ---------------------------------------------------------------- binning

def test_thresholds_few_uniques_are_exact():
    feats = np.array([[1.0], [3.0], [2.0], [1.0]], np.float32)
    thr, nb = compute_thresholds(feats, 256)
    assert nb[0] == 3
    assert np.allclose(thr[0, :3], [1.0, 2.0, 3.0])
    assert np.isinf(thr[0, 3:]).all()


def test_thresholds_many_uniques_grid():
    feats = np.arange(1000, dtype=np.float32)[:, None]
    thr, nb = compute_thresholds(feats, 16)
    assert nb[0] == 16
    assert thr[0, 0] == 0.0 and thr[0, 15] == 999.0


def test_binning_roundtrip_semantics():
    feats = np.array([[1.0], [3.0], [2.0], [1.5]], np.float32)
    thr, _ = compute_thresholds(feats, 256)
    binned = bin_features(feats, thr)
    # value <= thresholds[b]  ⟺  bin <= b
    for i in range(len(feats)):
        for b in range(3):
            assert (feats[i, 0] <= thr[0, b]) == (binned[i, 0] <= b)


# ---------------------------------------------------------------- growth

def _grow_np(feats, grad, n_leaves, mls=1, tc=256):
    thr, _ = compute_thresholds(feats, tc)
    binned = bin_features(feats, thr)
    arr = grow_tree(binned.T, grad.astype(np.float32), n_bins=thr.shape[1],
                    n_leaves=n_leaves, min_leaf_support=mls)
    return arr, thr


def test_single_split_golden():
    # one feature, responses cleanly separable at x <= 2
    feats = np.array([[1.0], [2.0], [3.0], [4.0]], np.float32)
    grad = np.array([10.0, 10.0, -10.0, -10.0])
    arr, thr = _grow_np(feats, grad, n_leaves=2)
    feature = np.asarray(arr.feature)
    sbin = np.asarray(arr.bin)
    assert int(np.asarray(arr.n_nodes)) == 3
    assert feature[0] == 0
    assert thr[0, sbin[0]] == 2.0            # split at x <= 2
    node = np.asarray(arr.node_of_doc)
    assert node[0] == node[1] and node[2] == node[3] and node[0] != node[2]
    out = np.asarray(leaf_outputs(arr.node_of_doc,
                                  np.asarray(grad, np.float32), None, 3, False))
    assert out[node[0]] == pytest.approx(10.0)
    assert out[node[2]] == pytest.approx(-10.0)


def test_best_feature_selected():
    # feature 1 separates perfectly; feature 0 is noise
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=32).astype(np.float32)
    x1 = np.concatenate([np.zeros(16), np.ones(16)]).astype(np.float32)
    grad = np.concatenate([np.full(16, -5.0), np.full(16, 5.0)])
    feats = np.stack([x0, x1], axis=1)
    arr, thr = _grow_np(feats, grad, n_leaves=2)
    assert np.asarray(arr.feature)[0] == 1


def test_min_leaf_support_respected():
    feats = np.array([[1.0], [2.0], [3.0], [4.0]], np.float32)
    grad = np.array([100.0, 1.0, 1.0, 1.0])
    arr, _ = _grow_np(feats, grad, n_leaves=2, mls=2)
    # best unconstrained split (x<=1) violates mls=2; must pick x<=2
    node = np.asarray(arr.node_of_doc)
    assert (node[:2] == node[0]).all() and (node[2:] == node[2]).all()


def test_leafwise_priority_by_deviance():
    # two clusters; the high-variance one must be split first when only
    # 3 leaves are allowed
    feats = np.array([[float(i)] for i in range(8)], np.float32)
    grad = np.array([0.0, 0.1, 0.0, 0.1, -50.0, 50.0, -50.0, 50.0])
    arr, thr = _grow_np(feats, grad, n_leaves=3)
    node = np.asarray(arr.node_of_doc)
    # both splits go to the high-variance half: docs 0..3 share one leaf,
    # docs 4..7 are subdivided
    assert len(set(node[:4].tolist())) == 1
    assert len(set(node[4:].tolist())) > 1


def test_unsplittable_constant_feature():
    feats = np.ones((6, 1), np.float32)
    grad = np.arange(6, dtype=np.float32)
    arr, _ = _grow_np(feats, grad, n_leaves=4)
    assert int(np.asarray(arr.n_nodes)) == 1      # root stays a leaf
    assert np.asarray(arr.is_leaf)[0]


# ---------------------------------------------------------------- ensemble

def _toy_tree():
    #      root: f0 <= 1.5
    #      left -> leaf 0.5 ; right -> f1 <= 0.0 -> leaves -1.0 / 2.0
    return Tree(
        feature=[0, 0, 1, 0, 0], threshold=[1.5, 0, 0.0, 0, 0],
        left=[1, -1, 3, -1, -1], right=[2, -1, 4, -1, -1],
        is_leaf=[False, True, False, True, True],
        output=[0.0, 0.5, 0.0, -1.0, 2.0],
    )


def test_tree_eval_and_xml_roundtrip():
    ens = TreeEnsemble()
    ens.add(_toy_tree(), 0.1)
    X = np.array([[1.0, 9.9], [2.0, -1.0], [2.0, 1.0]], np.float32)
    got = ens.eval_matrix(X)
    assert np.allclose(got, [0.05, -0.1, 0.2], atol=1e-6)

    text = ens.to_text()
    assert "<ensemble>" in text and 'pos="left"' in text
    ens2 = TreeEnsemble.from_text(text)
    assert np.allclose(ens2.eval_matrix(X), got, atol=1e-6)


def test_parse_ranklib_style_xml():
    # formatted exactly like the reference writes it (tabs, spaced values)
    text = """## LambdaMART
## No. of trees = 1

<ensemble>
\t<tree id="1" weight="0.1">
\t\t<split>
\t\t\t<feature> 2 </feature>
\t\t\t<threshold> 0.5 </threshold>
\t\t\t<split pos="left">
\t\t\t\t<output> -1.5 </output>
\t\t\t</split>
\t\t\t<split pos="right">
\t\t\t\t<output> 2.5 </output>
\t\t\t</split>
\t\t</split>
\t</tree>
</ensemble>
"""
    ens = TreeEnsemble.from_text(text)
    X = np.array([[0.0, 0.2], [0.0, 0.9]], np.float32)
    assert np.allclose(ens.eval_matrix(X), [-0.15, 0.25], atol=1e-6)


# ---------------------------------------------------------------- rankers

@pytest.fixture(scope="module")
def ranking_data():
    train = synth_dataset(n_queries=24, n_features=8, min_docs=8, max_docs=24,
                          seed=1, w_seed=7, signal=3.0)
    test = synth_dataset(n_queries=12, n_features=8, min_docs=8, max_docs=24,
                         seed=2, w_seed=7, signal=3.0)
    return train, test


def test_mart_learns(ranking_data):
    train, test = ranking_data
    scorer = create_scorer("NDCG@10")
    r = MART(n_trees=30, n_leaves=6, learning_rate=0.2)
    base = _random_metric(test, scorer)
    r.fit(train, scorer)
    assert r.score_metric(test, scorer) > base + 0.05


def test_lambdamart_learns_and_beats_pointwise_start(ranking_data):
    train, test = ranking_data
    scorer = create_scorer("NDCG@10")
    r = LambdaMART(n_trees=30, n_leaves=6, learning_rate=0.2)
    r.fit(train, scorer)
    m = r.score_metric(test, scorer)
    assert m > _random_metric(test, scorer) + 0.05
    assert r.score_metric(train, scorer) > 0.85


def test_lambdamart_validation_rollback(ranking_data):
    train, test = ranking_data
    scorer = create_scorer("NDCG@10")
    r = LambdaMART(n_trees=12, n_leaves=4, learning_rate=0.3, early_stop=5)
    r.fit(train, scorer, validation=test)
    assert 1 <= len(r.ensemble) <= 12


def test_gbdt_save_load_roundtrip(tmp_path, ranking_data):
    train, test = ranking_data
    scorer = create_scorer("NDCG@10")
    r = LambdaMART(n_trees=8, n_leaves=4, learning_rate=0.2)
    r.fit(train, scorer)
    path = tmp_path / "lm.txt"
    r.save(str(path))
    text = path.read_text()
    assert text.startswith("## LambdaMART")
    r2 = load_ranker_file(str(path))
    for a, b in zip(r.eval_dataset(test), r2.eval_dataset(test)):
        assert np.allclose(a, b, atol=1e-5)


def _random_metric(ds, scorer):
    """Metric of an untrained (zero-score) ranking: file order."""
    from ranklib_tpu.metrics.base import score_dataset
    zeros = [np.zeros(q.n, np.float32) for q in ds.queries]
    return score_dataset(scorer, ds, zeros)[0]


@pytest.mark.parametrize("metric", ["ERR@10", "MAP", "P@5", "RR@5",
                                    "BEST@5"])
def test_lambdamart_trains_with_other_metrics(ranking_data, metric):
    # the lambda kernel is metric-generic: exercise the other swap-delta
    # kernels through actual training rounds
    train, test = ranking_data
    scorer = create_scorer(metric)
    r = LambdaMART(n_trees=6, n_leaves=4, learning_rate=0.3)
    r.fit(train, scorer)
    assert np.isfinite(r.score_metric(test, scorer))
    assert len(r.ensemble) == 6


def test_matmul_eval_matches_traversal():
    # the serving path (matmul-only) must agree exactly with pointer
    # traversal on random structurally-valid trees
    import __graft_entry__ as g
    from ranklib_tpu.gbdt.ensemble import _ensemble_eval
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    ens = g._synthetic_ensemble(n_trees=37, n_leaves=7, n_features=12,
                                rng=rng)
    X = rng.normal(size=(257, 12)).astype(np.float32)
    got = ens.eval_matrix(X)
    feat, thr, lft, rgt, leaf, out, w, depth = ens._pack()
    want = np.asarray(_ensemble_eval(jnp.asarray(X), feat, thr, lft, rgt,
                                     leaf, out, w, depth))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_warm_start_and_checkpoint(tmp_path, ranking_data):
    train, test = ranking_data
    scorer = create_scorer("NDCG@10")
    ck = tmp_path / "ck.txt"
    # train 10 trees with checkpoints every 4 rounds
    r = LambdaMART(n_trees=10, n_leaves=4, learning_rate=0.2,
                   ckpt_every=4, ckpt_path=str(ck))
    r.fit(train, scorer)
    assert ck.exists()
    ck_model = load_ranker_file(str(ck))
    assert len(ck_model.ensemble) in (4, 8)

    # resume from the checkpoint to the full 10 trees
    r2 = load_ranker_file(str(ck))
    r2.n_trees = 10
    r2.fit(train, scorer)
    assert len(r2.ensemble) == 10
    # warm-started model must be in the same quality ballpark as the
    # straight-through run (identical up to checkpoint, greedy after)
    m1 = r.score_metric(test, scorer)
    m2 = r2.score_metric(test, scorer)
    assert abs(m1 - m2) < 0.05


def test_lambdamart_beats_linear_on_nonlinear_data():
    # the quality property that defines the GBDT family: on
    # threshold/interaction signal, trees must clearly beat linear
    from ranklib_tpu.models.linear import LinearRegRank

    kw = dict(n_features=16, min_docs=10, max_docs=24, gmax=2, w_seed=11,
              signal=3.0, nonlinear=True)
    train = synth_dataset(n_queries=60, seed=3, **kw)
    test = synth_dataset(n_queries=30, seed=5, **kw)
    scorer = create_scorer("NDCG@10")
    lin = LinearRegRank()
    lin.fit(train, scorer)
    lm = LambdaMART(n_trees=40, n_leaves=8, learning_rate=0.3, early_stop=0)
    lm.fit(train, scorer)
    m_lin = lin.score_metric(test, scorer)
    m_lm = lm.score_metric(test, scorer)
    assert m_lm > m_lin + 0.05, (m_lm, m_lin)


def test_feature_impacts_accumulate():
    """Impacts: nonnegative deviance reductions, mass only on features the
    ensemble actually split on (ref: LambdaMART impacts[])."""
    from tests.fixtures import synth_dataset
    from ranklib_tpu.metrics.base import create_scorer
    from ranklib_tpu.models.gbdt import MART

    ds = synth_dataset(n_queries=12, n_features=6, min_docs=8, max_docs=16,
                       seed=3, w_seed=4, signal=3.0)
    r = MART(n_trees=5, n_leaves=4, learning_rate=0.2)
    r.fit(ds, create_scorer("NDCG@10"))
    imp = r.feature_impacts
    assert imp is not None and imp.shape == (6,)
    assert (imp >= -1e-5).all()
    assert imp.sum() > 0
    used = {int(f) for t in r.ensemble.trees
            for f, leaf in zip(t.feature, t.is_leaf) if not leaf}
    unused = set(range(6)) - used
    for f in unused:
        assert imp[f] == pytest.approx(0.0, abs=1e-6)


def test_weighted_docs_equal_duplication():
    """grow_tree with doc weight k must produce the same tree as physically
    duplicating the doc k times (the RF weighted-bag contract)."""
    import jax.numpy as jnp
    from ranklib_tpu.gbdt.grow import grow_tree

    rng = np.random.default_rng(0)
    N, F, B = 64, 5, 8
    binned = rng.integers(0, B, size=(N, F)).astype(np.int32)
    grad = rng.normal(size=N).astype(np.float32)
    mult = rng.integers(1, 4, size=N)

    # physical duplication
    rows = np.repeat(np.arange(N), mult)
    t_dup = grow_tree(jnp.asarray(binned[rows].T), jnp.asarray(grad[rows]),
                      n_bins=B, n_leaves=5)
    # weighted
    t_w = grow_tree(jnp.asarray(binned.T), jnp.asarray(grad),
                    n_bins=B, n_leaves=5,
                    doc_mask=jnp.asarray(mult.astype(np.float32)))

    assert int(t_dup.n_nodes) == int(t_w.n_nodes)
    n = int(t_w.n_nodes)
    assert np.array_equal(np.asarray(t_dup.feature[:n]), np.asarray(t_w.feature[:n]))
    assert np.array_equal(np.asarray(t_dup.bin[:n]), np.asarray(t_w.bin[:n]))
    assert np.allclose(np.asarray(t_dup.impacts), np.asarray(t_w.impacts),
                       rtol=1e-4, atol=1e-4)


def test_grow_forest_matches_per_bag_grow_tree():
    """Lockstep forest growth (the batched RF path) is bag-for-bag
    BIT-IDENTICAL to growing each bag's tree alone: structure, doc
    assignment, and (to fp tolerance) impacts and leaf outputs."""
    import jax.numpy as jnp

    from ranklib_tpu.gbdt.grow import grow_forest, leaf_outputs_forest

    rng = np.random.default_rng(17)
    N, F, B, Cb, L = 600, 8, 16, 5, 7
    binned = jnp.asarray(rng.integers(0, B, size=(F, N)).astype(np.int32))
    grads = jnp.asarray(rng.normal(size=(Cb, N)).astype(np.float32))
    dw = jnp.asarray(rng.integers(0, 3, size=(Cb, N)).astype(np.float32))
    fmask = rng.random((Cb, F)) > 0.4
    fmask[:, 0] = True
    fmask = jnp.asarray(fmask)

    fr = grow_forest(binned, grads, n_bins=B, n_leaves=L,
                     min_leaf_support=2, doc_weights=dw,
                     feature_masks=fmask)
    M = 2 * L - 1
    lo_f = leaf_outputs_forest(fr.node_of_doc, grads, jnp.abs(grads), M,
                               True, dw)
    for c in range(Cb):
        tr = grow_tree(binned, grads[c], n_bins=B, n_leaves=L,
                       min_leaf_support=2, doc_mask=dw[c],
                       feature_mask=fmask[c])
        for name in ("feature", "bin", "left", "right", "is_leaf",
                     "n_nodes", "node_of_doc"):
            np.testing.assert_array_equal(
                np.asarray(getattr(fr, name)[c]),
                np.asarray(getattr(tr, name)), err_msg=name)
        np.testing.assert_allclose(np.asarray(fr.impacts[c]),
                                   np.asarray(tr.impacts),
                                   rtol=1e-5, atol=1e-4)
        lo_t = leaf_outputs(tr.node_of_doc, grads[c], jnp.abs(grads[c]), M,
                            True, dw[c])
        np.testing.assert_allclose(np.asarray(lo_f[c]), np.asarray(lo_t),
                                   rtol=1e-5, atol=1e-5)


def test_grow_forest_zero_weight_bag_is_inert():
    """Zero-weight pad bags (the final undersized RF group) grow nothing
    and poison nothing."""
    import jax.numpy as jnp

    from ranklib_tpu.gbdt.grow import grow_forest

    rng = np.random.default_rng(3)
    N, F, B = 300, 4, 8
    binned = jnp.asarray(rng.integers(0, B, size=(F, N)).astype(np.int32))
    grads = jnp.asarray(rng.normal(size=(2, N)).astype(np.float32))
    dw = jnp.asarray(
        np.stack([np.ones(N), np.zeros(N)]).astype(np.float32))
    fr = grow_forest(binned, grads, n_bins=B, n_leaves=4, doc_weights=dw)
    assert int(fr.n_nodes[0]) > 1          # real bag grew
    assert int(fr.n_nodes[1]) == 1         # pad bag: root only
    assert bool(fr.is_leaf[1, 0])


@pytest.mark.parametrize("metric", ["NDCG@10", "ERR@10"])
def test_lambda_path_sorted_flag_matches_auto(ranking_data, metric):
    """The lambda_path='sorted' A/B switch must
    train the same model as the default routing."""
    train, _ = ranking_data
    scorer = create_scorer(metric)
    models = []
    for path in ("auto", "sorted"):
        import ranklib_tpu.gbdt.boost as B

        orig = B.make_round_step
        import functools

        def patched(*a, _orig=orig, _p=path, **kw):
            kw["lambda_path"] = _p
            return _orig(*a, **kw)

        B.make_round_step = patched
        try:
            import ranklib_tpu.models.gbdt as G
            G.make_round_step = patched
            r = LambdaMART(n_trees=4, n_leaves=4, learning_rate=0.3)
            r.fit(train, scorer)
            models.append(r)
        finally:
            B.make_round_step = orig
            G.make_round_step = orig
    a, b = (m.ensemble for m in models)
    assert len(a) == len(b) == 4
    for ta, tb in zip(a.trees, b.trees):
        # identical split structure; leaf outputs differ only by float
        # reduction order between the two lambda formulations
        assert np.array_equal(ta.feature, tb.feature)
        assert np.array_equal(ta.threshold, tb.threshold)
        assert np.array_equal(ta.left, tb.left)
        np.testing.assert_allclose(ta.output, tb.output, rtol=1e-4,
                                   atol=1e-5)


def test_single_leaf_rejected():
    from ranklib_tpu.utils.errors import RankLibError
    with pytest.raises(RankLibError, match="-leaf"):
        LambdaMART(n_leaves=1)


def test_silent_mode_early_stop_identical():
    """Silent mode batches host syncs (checks early stop every `check`
    rounds); the STOP ROUND and the exported model must still be identical
    to per-round checking — the reference's rule replayed over the device
    history (models/gbdt._stop_round)."""
    from ranklib_tpu.utils.logging import set_silent

    train = synth_dataset(n_queries=12, n_features=6, min_docs=5,
                          max_docs=14, gmax=2, seed=31)
    val = synth_dataset(n_queries=6, n_features=6, min_docs=5, max_docs=14,
                        gmax=2, seed=32, w_seed=31)
    scorer = create_scorer("NDCG@10")

    def fit(silent):
        set_silent(silent)
        try:
            r = LambdaMART(n_trees=25, n_leaves=4, early_stop=4)
            r.fit(train, scorer, validation=val)
        finally:
            set_silent(False)
        return r.model_str()

    assert fit(True) == fit(False)


def test_best_splits_mls_zero_rejects_empty_sides():
    """-mls 0: an empty-side candidate scores the parent term and can
    TIE a proper split; the reference's 0/0 → NaN never selects it, so
    the scan must reject zero-count sides too (review finding)."""
    import jax.numpy as jnp

    from ranklib_tpu.ops.split_scan import best_splits

    # constant gradients: counts [0, 2, 2], sums equal counts — the
    # empty-left candidate (b=0) exactly ties the proper split (b=1)
    hist = np.zeros((1, 1, 3, 2), np.float32)
    hist[0, 0, :, 1] = [0.0, 2.0, 2.0]
    hist[0, 0, :, 0] = [0.0, 2.0, 2.0]
    g, f, b, ok = best_splits(jnp.asarray(hist), mls=0.0)
    assert bool(ok[0]) and int(b[0]) == 1


@pytest.mark.parametrize("thr", ["", "<threshold>   </threshold>"])
def test_split_without_threshold_is_a_clean_error(thr):
    """An internal <split> with <feature> but no usable <threshold> must
    raise RankLibError (the CLI's error path), not AttributeError."""
    from ranklib_tpu.utils.errors import RankLibError

    text = ("<ensemble><tree id=\"1\" weight=\"0.1\"><split>"
            f"<feature> 2 </feature>{thr}"
            "<split pos=\"left\"><output> 1.0 </output></split>"
            "<split pos=\"right\"><output> -1.0 </output></split>"
            "</split></tree></ensemble>")
    with pytest.raises(RankLibError, match="threshold"):
        TreeEnsemble.from_text(text)


def test_deep_chain_tree_xml_roundtrip():
    """A chain tree deeper than Python's recursion limit must save and
    re-load (leaf-wise growth at large -leaf can produce near-chain
    trees; the recursive DFS RecursionError'd past ~1000 levels — review
    finding, round 5). Text round-trip only: byte-stable and slot-exact."""
    D = 1500
    n = 2 * D + 1
    feature = np.zeros(n, np.int32)
    threshold = np.zeros(n, np.float32)
    left = np.zeros(n, np.int32)
    right = np.zeros(n, np.int32)
    is_leaf = np.ones(n, bool)
    output = np.zeros(n, np.float32)
    for i in range(D):
        is_leaf[2 * i] = False
        threshold[2 * i] = float(i)
        left[2 * i] = 2 * i + 1
        right[2 * i] = 2 * i + 2
        output[2 * i + 1] = float(i)
    output[2 * D] = -1.0
    t = Tree(feature, threshold, left, right, is_leaf, output)
    assert t.depth() == D
    ens = TreeEnsemble()
    ens.add(t, 0.1)
    text = ens.to_text()
    back = TreeEnsemble.from_text(text)
    assert back.to_text() == text
    bt = back.trees[0]
    np.testing.assert_array_equal(bt.is_leaf, t.is_leaf)
    np.testing.assert_array_equal(bt.threshold, t.threshold)
