"""Host-CSR pipeline for raw-value rankers.

The reference serves ALL rankers from storage-level sparse vectors
(ref: learning/SparseDataPoint.java:~15); here `-sparse` lands the file
in host CSR (data/sparse.py) and neural/linear/CoorAscent/AdaRank train
from bounded dense chunks. These tests pin: reader equivalence vs the
dense parser, bit-parity of trained models through the CSR path (incl.
forced tiny chunking), the CLI flow, and the actual host-RAM ceiling.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from ranklib_tpu.data.dataset import bucketize
from ranklib_tpu.data.letor import read_letor
from ranklib_tpu.data.sparse import CSRDataset, read_letor_sparse
from ranklib_tpu.metrics.base import create_scorer, score_dataset
from tests.fixtures import synth_dataset


def _write_sparse_letor(ds, path, keep_prob=0.4, seed=0):
    """Write ds as a LETOR file OMITTING ~1-keep_prob of the entries
    (zeroing them) — the written file is the ground truth both pipelines
    then read."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for q in ds.queries:
            for i in range(q.n):
                keep = rng.random(q.feats.shape[1]) < keep_prob
                pairs = " ".join(
                    f"{j + 1}:{q.feats[i, j]:.6g}"
                    for j in range(q.feats.shape[1]) if keep[j])
                if not pairs:          # always keep at least one pair
                    pairs = f"1:{q.feats[i, 0]:.6g}"
                f.write(f"{int(q.labels[i])} qid:{q.qid} {pairs}\n")


@pytest.fixture()
def sparse_file(tmp_path):
    ds = synth_dataset(n_queries=12, n_features=9, min_docs=5, max_docs=14,
                       gmax=2, seed=201)
    path = str(tmp_path / "sparse.txt")
    _write_sparse_letor(ds, path)
    return path


def test_csr_reader_matches_dense(sparse_file):
    dense = read_letor(sparse_file)
    csr = read_letor_sparse(sparse_file, quiet=True)
    assert isinstance(csr, CSRDataset)
    assert csr.n_features == dense.n_features
    assert len(csr.queries) == len(dense.queries)
    full = csr.materialize_rows(0, csr.n_docs)
    from ranklib_tpu.data.dataset import flatten
    feats_d, labels_d, _ = flatten(dense)
    np.testing.assert_array_equal(full, feats_d)
    for qd, qc in zip(dense.queries, csr.queries):
        assert qd.qid == qc.qid
        np.testing.assert_array_equal(qd.labels, qc.labels)


def test_csr_python_fallback_matches_native(sparse_file):
    from ranklib_tpu.data.sparse import _py_parse_csr
    from ranklib_tpu.native.loader import native_parse_letor_csr

    nat = native_parse_letor_csr(sparse_file)
    if nat is None:
        pytest.skip("native parser unavailable")
    py = _py_parse_csr(sparse_file)
    for a, b, name in zip(nat, py, ("labels", "qptr", "qids", "indptr",
                                    "fids", "vals", "counts", "max_fid")):
        if name in ("qids",):
            assert a == b
        elif name == "max_fid":
            assert int(a) == int(b)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_csr_bucketize_chunking_preserves_order(sparse_file, monkeypatch):
    csr = read_letor_sparse(sparse_file, quiet=True)
    dense = read_letor(sparse_file)
    full = bucketize(dense)
    monkeypatch.setenv("RANKLIB_TPU_SPARSE_CHUNK_MB", "1")
    chunked = bucketize(csr)
    assert len(chunked) >= len(full)
    order_full = [qi for b in full for qi in b.qidx]
    order_chunk = [qi for b in chunked for qi in b.qidx]
    assert order_full == order_chunk
    # row-for-row identical content
    rows_f = np.concatenate([b.feats.reshape(-1, dense.n_features)
                             for b in full])
    rows_c = np.concatenate([b.feats.reshape(-1, dense.n_features)
                             for b in chunked])
    np.testing.assert_array_equal(rows_f, rows_c)


@pytest.mark.parametrize("chunk_mb", ["256", "1"])
def test_csr_rankers_bit_parity_vs_dense(sparse_file, monkeypatch, chunk_mb):
    """Training through CSR (whole buckets AND forced tiny chunks) yields
    the same models as the dense pipeline on the same file."""
    from ranklib_tpu.models.adarank import AdaRank
    from ranklib_tpu.models.coorascent import CoorAscent
    from ranklib_tpu.models.linear import LinearRegRank
    from ranklib_tpu.models.neural import RankNet

    monkeypatch.setenv("RANKLIB_TPU_SPARSE_CHUNK_MB", chunk_mb)
    dense = read_letor(sparse_file)
    csr = read_letor_sparse(sparse_file, quiet=True)
    scorer = create_scorer("NDCG@10")

    lin_d, lin_c = LinearRegRank(), LinearRegRank()
    lin_d.fit(dense)
    lin_c.fit(csr)
    np.testing.assert_allclose(lin_d.weights, lin_c.weights, atol=1e-9)

    nn_d = RankNet(n_epoch=3, learning_rate=0.001)
    nn_c = RankNet(n_epoch=3, learning_rate=0.001)
    nn_d.fit(dense, scorer)
    nn_c.fit(csr, scorer)
    for (Wd, bd), (Wc, bc) in zip(nn_d.params, nn_c.params):
        np.testing.assert_array_equal(Wd, Wc)
        np.testing.assert_array_equal(bd, bc)

    ca_d = CoorAscent(n_restart=1, max_passes=2)
    ca_c = CoorAscent(n_restart=1, max_passes=2)
    ca_d.fit(dense, scorer)
    ca_c.fit(csr, scorer)
    np.testing.assert_array_equal(ca_d.weights, ca_c.weights)

    ada_d, ada_c = AdaRank(n_rounds=8), AdaRank(n_rounds=8)
    ada_d.fit(dense, scorer)
    ada_c.fit(csr, scorer)
    assert ada_d.history == ada_c.history

    # scoring stacks agree too (CSR materializes per query at eval)
    for m_d, m_c in ((lin_d, lin_c), (nn_d, nn_c), (ca_d, ca_c)):
        sd = score_dataset(scorer, dense, m_d.eval_dataset(dense))[0]
        sc = score_dataset(scorer, csr, m_c.eval_dataset(csr))[0]
        assert sd == pytest.approx(sc, abs=1e-7)


def test_csr_subset_and_split(sparse_file):
    csr = read_letor_sparse(sparse_file, quiet=True)
    dense = read_letor(sparse_file)
    sub_c = csr.subset_features([2, 5])
    sub_d = dense.subset_features([2, 5])
    from ranklib_tpu.data.dataset import flatten
    np.testing.assert_array_equal(
        sub_c.materialize_rows(0, sub_c.n_docs), flatten(sub_d)[0])

    from ranklib_tpu.data.cv import split_tvs
    (tr_c, va_c), (tr_d, va_d) = split_tvs(csr, 0.7), split_tvs(dense, 0.7)
    assert [q.qid for q in tr_c.queries] == [q.qid for q in tr_d.queries]
    np.testing.assert_array_equal(
        va_c.materialize_rows(0, va_c.n_docs), flatten(va_d)[0])

    wide = csr.with_width(csr.n_features + 3)
    assert wide.materialize_rows(0, 2).shape[1] == csr.n_features + 3


def test_csr_cli_flow(tmp_path, sparse_file):
    """-sparse -ranker 4 end-to-end: same printed metrics as dense."""
    from ranklib_tpu.cli import main as cli_main

    test_ds = synth_dataset(n_queries=5, n_features=9, min_docs=5,
                            max_docs=12, gmax=2, seed=202, w_seed=201)
    test_path = str(tmp_path / "test.txt")
    _write_sparse_letor(test_ds, test_path, seed=1)

    outs = {}
    for tag, extra in (("dense", []), ("csr", ["-sparse"])):
        model = str(tmp_path / f"m_{tag}.txt")
        cli_main(["-train", sparse_file, "-ranker", "4", "-r", "1",
                  "-metric2t", "NDCG@10", "-test", test_path,
                  "-missingZero", "-save", model, *extra])
        outs[tag] = open(model).read()
    assert outs["dense"] == outs["csr"]


@pytest.mark.slow
def test_csr_memory_budget(tmp_path):
    """The point of the exercise: a wide sparse file trains -ranker 9
    inside a host-RAM budget far below its dense matrix. 500 queries x
    80 docs x F=2000 at ~10 pairs/doc: dense is 320 MB; the CSR path with
    64 MB chunks must stay under 170 MB of numpy allocations (tracemalloc
    peak, subprocess-isolated)."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "wide.txt")
    F, n_q, n_d = 2000, 500, 80
    with open(path, "w") as f:
        for q in range(n_q):
            for _ in range(n_d):
                fids = np.unique(rng.integers(1, F + 1, 10))
                pairs = " ".join(f"{fid}:{rng.normal():.4g}" for fid in fids)
                f.write(f"{int(rng.integers(0, 3))} qid:{q + 1} {pairs}\n")
    code = f"""
import tracemalloc, sys
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
import jax; jax.config.update("jax_platforms", "cpu")
from ranklib_tpu.data.sparse import read_letor_sparse
from ranklib_tpu.models.linear import LinearRegRank
tracemalloc.start()
ds = read_letor_sparse({path!r}, quiet=True)
r = LinearRegRank()
r.fit(ds)
peak = tracemalloc.get_traced_memory()[1]
assert len(r.weights) == ds.n_features + 1
print("PEAK_MB", peak / (1 << 20))
"""
    env = dict(os.environ, RANKLIB_TPU_SPARSE_CHUNK_MB="64",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    peak_mb = float(res.stdout.strip().split()[-1])
    dense_mb = n_q * n_d * F * 4 / (1 << 20)
    assert peak_mb < 170, (peak_mb, dense_mb)
    assert dense_mb > 300          # the ceiling we demonstrably stayed under


def test_rankboost_csr_parity(sparse_file):
    """RankBoost through CSR (chunked min/max + int16 bins): identical
    weak-ranker sequence to the dense pipeline, incl. validation."""
    from ranklib_tpu.models.rankboost import RankBoost

    dense = read_letor(sparse_file)
    csr = read_letor_sparse(sparse_file, quiet=True)
    scorer = create_scorer("NDCG@10")
    rb_d, rb_c = RankBoost(n_rounds=10, n_threshold=6), \
        RankBoost(n_rounds=10, n_threshold=6)
    rb_d.fit(dense, scorer)
    rb_c.fit(csr, scorer)
    assert rb_d.weaks == rb_c.weaks
    for sd, sc in zip(rb_d.eval_dataset(dense), rb_c.eval_dataset(csr)):
        np.testing.assert_array_equal(sd, sc)


def test_csr_load_flows(tmp_path, sparse_file):
    """-sparse on the load+test / load+rank flows, incl. a TREE model
    scored through chunked CSR materialization."""
    from ranklib_tpu.cli import main as cli_main

    model = str(tmp_path / "lm.txt")
    cli_main(["-train", sparse_file, "-ranker", "6", "-tree", "5",
              "-leaf", "4", "-metric2t", "NDCG@10", "-missingZero",
              "-save", model])
    outs = {}
    for tag, extra in (("dense", []), ("csr", ["-sparse"])):
        sc = str(tmp_path / f"sc_{tag}.txt")
        idv = str(tmp_path / f"idv_{tag}.txt")
        cli_main(["-load", model, "-test", sparse_file, "-metric2T",
                  "NDCG@10", "-missingZero", "-idv", idv, *extra])
        cli_main(["-load", model, "-rank", sparse_file, "-score", sc,
                  "-missingZero", *extra])
        outs[tag] = open(sc).read() + open(idv).read()
    assert outs["dense"] == outs["csr"]


def test_csr_kcv_flow(tmp_path, sparse_file):
    """-kcv through CSR: fold composition and fold models match dense."""
    from ranklib_tpu.cli import main as cli_main

    outs = {}
    for tag, extra in (("dense", []), ("csr", ["-sparse"])):
        d = str(tmp_path / f"kcv_{tag}")
        cli_main(["-train", sparse_file, "-ranker", "9", "-kcv", "3",
                  "-metric2t", "NDCG@10", "-missingZero",
                  "-kcvmd", d, "-kcvmn", "m", *extra])
        outs[tag] = "".join(
            open(os.path.join(d, f"f{i + 1}.m")).read() for i in range(3))
    assert outs["dense"] == outs["csr"]


def test_rf_scores_csr(sparse_file):
    """RF eval_dataset on a CSR dataset (review finding: it crashed)."""
    from ranklib_tpu.models.rf import RFRanker

    dense = read_letor(sparse_file)
    csr = read_letor_sparse(sparse_file, quiet=True)
    rf = RFRanker(n_bags=2, n_trees=1, n_leaves=4, seed=3)
    rf.fit(dense, create_scorer("NDCG@10"))
    for sd, sc in zip(rf.eval_dataset(dense), rf.eval_dataset(csr)):
        np.testing.assert_array_equal(sd, sc)


def test_kcv_sparse_gbdt_falls_back_dense(tmp_path, sparse_file):
    """-kcv -sparse with a tree ranker must not hand CSR folds to a fit
    that can't consume them (review finding: TypeError mid-run)."""
    from ranklib_tpu.cli import main as cli_main

    d = str(tmp_path / "kcv_gbdt")
    cli_main(["-train", sparse_file, "-ranker", "6", "-tree", "3",
              "-leaf", "3", "-kcv", "3", "-metric2t", "NDCG@10",
              "-missingZero", "-sparse", "-kcvmd", d, "-kcvmn", "m"])
    assert sorted(os.listdir(d)) == ["f1.m", "f2.m", "f3.m"]


def test_qrel_on_descless_dataset_errors():
    """apply_qrel on a dataset without '#' descriptions raises instead of
    silently zeroing every label (review finding)."""
    from ranklib_tpu.data.qrel import apply_qrel
    from ranklib_tpu.utils.errors import RankLibError
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                     delete=False) as f:
        f.write("1 qid:1 1:0.5\n0 qid:1 1:0.1\n")
        path = f.name
    with tempfile.NamedTemporaryFile("w", suffix=".qrel",
                                     delete=False) as f:
        f.write("1 0 doc1 2\n")
        qrel = f.name
    csr_ds = read_letor_sparse(path, quiet=True)
    with pytest.raises(RankLibError, match="descriptions"):
        apply_qrel(csr_ds, qrel)
    os.unlink(path)
    os.unlink(qrel)


def test_wide_grid_model_scores_like_traversal():
    """A model with >256 distinct thresholds on one feature (a grid no
    uint8 bin id can index) scores exactly through eval_matrix."""
    import jax.numpy as jnp

    from ranklib_tpu.gbdt.ensemble import Tree, TreeEnsemble, _ensemble_eval

    rng = np.random.default_rng(0)

    def stump(thr):
        return Tree(feature=np.array([0, 0, 0]),
                    threshold=np.array([thr, 0, 0], np.float32),
                    left=np.array([1, -1, -1]),
                    right=np.array([2, -1, -1]),
                    is_leaf=np.array([False, True, True]),
                    output=np.array([0.0, -1.0, 1.0], np.float32))

    wide = TreeEnsemble()
    for thr in rng.normal(size=300):
        wide.add(stump(np.float32(thr)), 0.1)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    X[:8, 0] = [t.threshold[0] for t in wide.trees[:8]]   # on-threshold
    fe, th, lf, rt, lv, ot, wt, depth = wide._pack()
    want = np.asarray(_ensemble_eval(jnp.asarray(X), fe, th, lf, rt, lv,
                                     ot, wt, depth=depth))
    np.testing.assert_allclose(wide.eval_matrix(X), want, atol=1e-5)


def test_kcv_sparse_gbdt_streams_binned(tmp_path, sparse_file):
    """-kcv -sparse tree rankers now ride the streamed bin matrix; fold
    models match the dense pipeline bit-for-bit (one global grid, exact
    parity of binned training pinned elsewhere)."""
    from ranklib_tpu.cli import main as cli_main

    outs = {}
    for tag, extra in (("dense", []), ("binned", ["-sparse"])):
        d = str(tmp_path / f"kcv6_{tag}")
        cli_main(["-train", sparse_file, "-ranker", "6", "-tree", "3",
                  "-leaf", "3", "-kcv", "3", "-metric2t", "NDCG@10",
                  "-missingZero", "-kcvmd", d, "-kcvmn", "m", *extra])
        outs[tag] = "".join(
            open(os.path.join(d, f"f{i + 1}.m")).read() for i in range(3))
    assert outs["dense"] == outs["binned"]


def test_feature_subset_on_binned_stream(tmp_path, sparse_file):
    """-feature + -sparse tree rankers: the split-feature MASK yields the
    same model as the dense pipeline's column zeroing."""
    from ranklib_tpu.cli import main as cli_main

    ff = str(tmp_path / "feats.txt")
    open(ff, "w").write("2\n3\n5\n7\n")
    outs = {}
    for tag, extra in (("dense", []), ("binned", ["-sparse"])):
        model = str(tmp_path / f"mf_{tag}.txt")
        cli_main(["-train", sparse_file, "-ranker", "6", "-tree", "4",
                  "-leaf", "3", "-metric2t", "NDCG@10", "-missingZero",
                  "-feature", ff, "-save", model, *extra])
        outs[tag] = open(model).read()
    assert outs["dense"] == outs["binned"]
    # only listed features appear in the trees
    import re
    fids = set(int(m) for m in re.findall(r"<feature> *(\d+) *</feature>",
                                          outs["binned"]))
    assert fids <= {2, 3, 5, 7}


@pytest.mark.parametrize("norm", ["sum", "zscore", "linear"])
def test_csr_normalization_bit_parity(sparse_file, norm):
    """-norm on CSR applies lazily at materialization with the EXACT
    dense formula — trained models bit-identical across pipelines."""
    from ranklib_tpu.data.normalize import normalize_dataset
    from ranklib_tpu.data.sparse import normalize_csr
    from ranklib_tpu.models.coorascent import CoorAscent
    from ranklib_tpu.models.linear import LinearRegRank
    from ranklib_tpu.models.rankboost import RankBoost
    from ranklib_tpu.data.dataset import flatten

    dense = read_letor(sparse_file)
    normalize_dataset(dense, norm)
    csr = normalize_csr(read_letor_sparse(sparse_file, quiet=True), norm)
    np.testing.assert_array_equal(csr.materialize_rows(0, csr.n_docs),
                                  flatten(dense)[0])

    scorer = create_scorer("NDCG@10")
    lin_d, lin_c = LinearRegRank(), LinearRegRank()
    lin_d.fit(dense)
    lin_c.fit(csr)
    np.testing.assert_allclose(lin_d.weights, lin_c.weights, atol=1e-9)
    ca_d = CoorAscent(n_restart=1, max_passes=2)
    ca_c = CoorAscent(n_restart=1, max_passes=2)
    ca_d.fit(dense, scorer)
    ca_c.fit(csr, scorer)
    np.testing.assert_array_equal(ca_d.weights, ca_c.weights)
    rb_d, rb_c = RankBoost(n_rounds=6, n_threshold=5), \
        RankBoost(n_rounds=6, n_threshold=5)
    rb_d.fit(dense, scorer)
    rb_c.fit(csr, scorer)
    assert rb_d.weaks == rb_c.weaks

    # splits / feature subsets carry the lazy stats correctly
    from ranklib_tpu.data.cv import split_tvs
    (tr_c, va_c) = split_tvs(csr, 0.7)
    (tr_d, va_d) = split_tvs(dense, 0.7)
    np.testing.assert_array_equal(
        va_c.materialize_rows(0, va_c.n_docs), flatten(va_d)[0])
    sub_c = csr.subset_features([2, 5])
    sub_d_q = [np.where(np.isin(np.arange(9), [1, 4])[None, :], q.feats, 0.0)
               for q in dense.queries]
    np.testing.assert_array_equal(
        sub_c.materialize_rows(0, sub_c.n_docs),
        np.concatenate(sub_d_q).astype(np.float32))


def test_csr_norm_cli_flow(tmp_path, sparse_file):
    from ranklib_tpu.cli import main as cli_main

    outs = {}
    for tag, extra in (("dense", []), ("csr", ["-sparse"])):
        model = str(tmp_path / f"mn_{tag}.txt")
        cli_main(["-train", sparse_file, "-ranker", "9", "-norm", "zscore",
                  "-metric2t", "NDCG@10", "-missingZero",
                  "-save", model, *extra])
        outs[tag] = open(model).read()
    assert outs["dense"] == outs["csr"]


def test_gbdt_norm_sparse_bit_parity(tmp_path, sparse_file):
    """-sparse -norm for tree rankers: CSR + lazy normalization bins from
    normalized chunks — model text byte-identical to the dense
    normalize-then-bin pipeline, incl. the test metric and kcv folds."""
    from ranklib_tpu.cli import main as cli_main

    test_ds = synth_dataset(n_queries=5, n_features=9, min_docs=5,
                            max_docs=12, gmax=2, seed=203, w_seed=201)
    test_path = str(tmp_path / "t2.txt")
    _write_sparse_letor(test_ds, test_path, seed=2)
    outs = {}
    for tag, extra in (("dense", []), ("csr", ["-sparse"])):
        model = str(tmp_path / f"g_{tag}.txt")
        cli_main(["-train", sparse_file, "-ranker", "6", "-tree", "4",
                  "-leaf", "3", "-norm", "zscore", "-metric2t", "NDCG@10",
                  "-test", test_path, "-missingZero",
                  "-save", model, *extra])
        outs[tag] = open(model).read()
    assert outs["dense"] == outs["csr"]

    kouts = {}
    for tag, extra in (("dense", []), ("csr", ["-sparse"])):
        d = str(tmp_path / f"gk_{tag}")
        cli_main(["-train", sparse_file, "-ranker", "0", "-tree", "3",
                  "-leaf", "3", "-norm", "sum", "-metric2t", "NDCG@10",
                  "-kcv", "3", "-missingZero", "-kcvmd", d,
                  "-kcvmn", "m", *extra])
        kouts[tag] = "".join(
            open(os.path.join(d, f"f{i + 1}.m")).read() for i in range(3))
    assert kouts["dense"] == kouts["csr"]


def test_csr_subset_after_narrowing_width(sparse_file):
    """subset_features after a NARROWING with_width (review finding: it
    crashed with IndexError when stored fids exceeded the new width)."""
    csr = read_letor_sparse(sparse_file, quiet=True)
    from ranklib_tpu.data.sparse import normalize_csr

    w = csr.n_features - 3
    narrowed = csr.with_width(w)
    sub = narrowed.subset_features([1, 2])
    got = sub.materialize_rows(0, sub.n_docs)
    want = csr.materialize_rows(0, csr.n_docs)[:, :w].copy()
    keep = np.zeros(w, bool)
    keep[[0, 1]] = True
    want[:, ~keep] = 0.0
    np.testing.assert_array_equal(got, want)

    # same sequence with lazy normalization attached (stats wider than
    # the narrowed width)
    normed = normalize_csr(csr, "zscore").with_width(w)
    sub_n = normed.subset_features([1, 2])
    assert sub_n.materialize_rows(0, sub_n.n_docs).shape[1] == w


# ---- '#' descriptions through the sparse loaders (-qrel / -indri) ----------

def _write_sparse_letor_descs(ds, path, keep_prob=0.4, seed=0):
    """_write_sparse_letor plus a '# doc<qid>_<i>' description per line."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for q in ds.queries:
            for i in range(q.n):
                keep = rng.random(q.feats.shape[1]) < keep_prob
                pairs = " ".join(
                    f"{j + 1}:{q.feats[i, j]:.6g}"
                    for j in range(q.feats.shape[1]) if keep[j])
                if not pairs:
                    pairs = f"1:{q.feats[i, 0]:.6g}"
                f.write(f"{int(q.labels[i])} qid:{q.qid} {pairs} "
                        f"# doc{q.qid}_{i}\n")


@pytest.fixture()
def sparse_desc_file(tmp_path):
    ds = synth_dataset(n_queries=12, n_features=9, min_docs=5, max_docs=14,
                       gmax=2, seed=203)
    path = str(tmp_path / "sparse_d.txt")
    _write_sparse_letor_descs(ds, path)
    return path


def test_sparse_loaders_carry_descs(sparse_desc_file):
    """want_descs on both sparse loaders matches the dense reader's
    descriptions doc-for-doc (native and Python desc passes)."""
    from ranklib_tpu.data.binned import read_letor_binned
    from ranklib_tpu.data.letor import read_descs
    from ranklib_tpu.utils.errors import RankLibError

    dense = read_letor(sparse_desc_file, quiet=True)
    want = [d for q in dense.queries for d in q.descs]

    csr = read_letor_sparse(sparse_desc_file, quiet=True, want_descs=True)
    got_csr = [d for q in csr.queries for d in q.descs]
    assert got_csr == want

    try:
        binned = read_letor_binned(sparse_desc_file, quiet=True,
                                   want_descs=True)
        got_bin = [d for q in binned.queries for d in q.descs]
        assert got_bin == want
    except RankLibError:
        pass                      # native parser unavailable (no g++)

    # python fallback pass (no n_docs hint disables the native path)
    assert read_descs(sparse_desc_file) == want
    # and the native pass, when available, agrees with the fallback
    n = sum(q.n for q in dense.queries)
    assert read_descs(sparse_desc_file, n) == want


@pytest.mark.parametrize("ranker,extra", [(9, []), (0, ["-tree", "3",
                                                        "-leaf", "3"])])
def test_sparse_qrel_cli_parity(tmp_path, sparse_desc_file, ranker, extra):
    """-sparse -qrel trains through the sparse loaders (CSR for raw-value
    rankers, streamed bins for GBDT) with labels — and therefore models —
    identical to the dense pipeline's."""
    from ranklib_tpu.cli import main as cli_main

    dense = read_letor(sparse_desc_file, quiet=True)
    qrel = tmp_path / "j.qrel"
    rng = np.random.default_rng(7)
    with open(qrel, "w") as f:
        for q in dense.queries:
            for i in range(q.n):
                f.write(f"{q.qid} 0 doc{q.qid}_{i} "
                        f"{int(rng.integers(0, 3))}\n")
    outs = {}
    for tag, sp in (("dense", []), ("sparse", ["-sparse"])):
        model = str(tmp_path / f"m_{tag}_{ranker}.txt")
        assert cli_main(["-train", sparse_desc_file, "-ranker", str(ranker),
                         "-metric2t", "NDCG@10", "-qrel", str(qrel),
                         "-missingZero", "-save", model, *extra, *sp]) == 0
        outs[tag] = open(model).read()
    assert outs["dense"] == outs["sparse"]


def test_sparse_indri_real_docids(tmp_path, sparse_desc_file):
    """-sparse -rank -indri outputs the real '#' docids, not doc<i>."""
    from ranklib_tpu.cli import main as cli_main

    model = str(tmp_path / "m9.txt")
    assert cli_main(["-train", sparse_desc_file, "-ranker", "9",
                     "-metric2t", "NDCG@10", "-missingZero",
                     "-save", model]) == 0
    ind = tmp_path / "out.indri"
    assert cli_main(["-load", model, "-rank", sparse_desc_file,
                     "-indri", str(ind), "-sparse", "-missingZero"]) == 0
    first = ind.read_text().splitlines()[0].split()
    qid, docid = first[0], first[2]
    assert docid.startswith(f"doc{qid}_")


def test_kcv_sparse_perfold_grids_match_dense(tmp_path, sparse_file):
    """The divergent case round-3 documented away: a feature with MORE
    than -tc distinct values. Per-fold grids (binned_from_csr on each
    fold's training rows) make the sparse kcv fold models byte-equal the
    dense pipeline's; the shared-grid fast path
    (RANKLIB_TPU_KCV_SHARED_GRID=1) is the one that diverges here."""
    import os as _os

    from ranklib_tpu.cli import main as cli_main

    outs = {}
    for tag, extra in (("dense", []), ("sparse", ["-sparse"])):
        d = str(tmp_path / f"kcvtc_{tag}")
        cli_main(["-train", sparse_file, "-ranker", "6", "-tree", "3",
                  "-leaf", "3", "-kcv", "3", "-tc", "8",
                  "-metric2t", "NDCG@10", "-missingZero",
                  "-kcvmd", d, "-kcvmn", "m", *extra])
        outs[tag] = "".join(
            open(os.path.join(d, f"f{i + 1}.m")).read() for i in range(3))
    assert outs["dense"] == outs["sparse"]

    # the documented fast path still runs end-to-end
    _os.environ["RANKLIB_TPU_KCV_SHARED_GRID"] = "1"
    try:
        d = str(tmp_path / "kcvtc_shared")
        cli_main(["-train", sparse_file, "-ranker", "6", "-tree", "3",
                  "-leaf", "3", "-kcv", "3", "-tc", "8",
                  "-metric2t", "NDCG@10", "-missingZero", "-sparse",
                  "-kcvmd", d, "-kcvmn", "m"])
        assert sorted(_os.listdir(d)) == ["f1.m", "f2.m", "f3.m"]
    finally:
        del _os.environ["RANKLIB_TPU_KCV_SHARED_GRID"]


def test_sparse_norm_stats_scale_with_nnz(tmp_path):
    """Per-query norm stats are stored sparsely (~nnz entries), not as
    [Q, F] arrays — a 500-query × 100K-feature file normalizes inside a
    tight host budget (the dense stat arrays alone would be ~400 MB)."""
    import tracemalloc

    from ranklib_tpu.data.sparse import normalize_csr

    rng = np.random.default_rng(0)
    path = str(tmp_path / "vwide.txt")
    F, n_q, n_d = 100_000, 500, 20
    with open(path, "w") as f:
        for q in range(n_q):
            for _ in range(n_d):
                fids = np.unique(rng.integers(1, F + 1, 10))
                pairs = " ".join(f"{fid}:{rng.normal():.4g}"
                                 for fid in fids)
                f.write(f"{int(rng.integers(0, 3))} qid:{q + 1} {pairs}\n")
    csr = read_letor_sparse(path, quiet=True)
    tracemalloc.start()
    normed = normalize_csr(csr, "zscore")
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert normed.ns_fids.size <= csr.nnz
    assert peak < 100 << 20, f"normalize peak {peak / (1 << 20):.0f} MB"
    # application still exact on a narrow slice of the wide space
    got = normed.materialize_rows(0, n_d)
    assert np.isfinite(got).all()


# ---- embedding-style sparse device layer (ops/sparse_eval.py) --------------

def test_coorascent_sparse_eval_parity(sparse_file, monkeypatch):
    """Forcing the gather/segment-sum candidate layer (budget -> 0) on
    narrow data reproduces the dense-bucket CoorAscent fit: identical
    coordinate decisions, weights within f32 reduction-order noise."""
    from ranklib_tpu.models.coorascent import CoorAscent

    scorer = create_scorer("NDCG@10")
    csr = read_letor_sparse(sparse_file, quiet=True)
    d = CoorAscent(n_restart=2, max_passes=3)
    d.fit(csr, scorer)
    monkeypatch.setenv("RANKLIB_TPU_DEVICE_DENSE_MB", "0")
    from ranklib_tpu.ops.sparse_eval import wants_sparse_eval
    assert wants_sparse_eval(csr)          # tiny budget routes CSR sparse
    s = CoorAscent(n_restart=2, max_passes=3)
    s.fit(csr, scorer)
    np.testing.assert_allclose(s.weights, d.weights, atol=2e-5)


def test_coorascent_sparse_eval_normalized_parity(sparse_file, monkeypatch):
    """The sparse layer inherits LAZY normalization through materialized
    chunks — parity with the dense path under -norm zscore (the
    densifying case)."""
    from ranklib_tpu.data.sparse import normalize_csr
    from ranklib_tpu.models.coorascent import CoorAscent

    scorer = create_scorer("NDCG@10")
    csr = normalize_csr(read_letor_sparse(sparse_file, quiet=True),
                        "zscore")
    d = CoorAscent(n_restart=1, max_passes=2)
    d.fit(csr, scorer)
    monkeypatch.setenv("RANKLIB_TPU_DEVICE_DENSE_MB", "0")
    s = CoorAscent(n_restart=1, max_passes=2)
    s.fit(csr, scorer)
    np.testing.assert_allclose(s.weights, d.weights, atol=2e-5)


@pytest.mark.slow
def test_coorascent_wide_sparse_trains(tmp_path):
    """The point: -ranker 4 on a 50K-feature sparse file — the dense
    device blocks would be ~480 MB on this slice (2.4K docs × 50K f32)
    and scale linearly with docs; the COO layer holds ~nnz. One sweep
    pass (a CA pass is inherently F coordinate evaluations — ~40 s of
    real work at this width on CPU)."""
    from ranklib_tpu.data.sparse import read_letor_sparse as _read
    from ranklib_tpu.models.coorascent import CoorAscent
    from ranklib_tpu.ops.sparse_eval import wants_sparse_eval

    rng = np.random.default_rng(0)
    path = str(tmp_path / "wide50k.txt")
    F, n_q, n_d = 50_000, 60, 40
    with open(path, "w") as f:
        for q in range(n_q):
            for _ in range(n_d):
                fids = np.unique(rng.integers(1, F + 1, 10))
                pairs = " ".join(f"{fid}:{rng.normal():.4g}"
                                 for fid in fids)
                f.write(f"{int(rng.integers(0, 3))} qid:{q + 1} {pairs}\n")
    csr = _read(path, quiet=True)
    import os as _os
    _os.environ["RANKLIB_TPU_DEVICE_DENSE_MB"] = "256"
    try:
        assert wants_sparse_eval(csr)      # 480 MB dense > 256 MB budget
        r = CoorAscent(n_restart=1, max_passes=1, n_max_iteration=4)
        r.fit(csr, create_scorer("NDCG@10"))
    finally:
        del _os.environ["RANKLIB_TPU_DEVICE_DENSE_MB"]
    assert r.weights is not None and np.isfinite(r.weights).all()
    assert r.model_str().startswith("## Coordinate Ascent")


def test_adarank_sparse_eval_parity(sparse_file, monkeypatch):
    """AdaRank's wide route (S built sparsely + strong-model scoring
    through the gather/segment-sum layer) reproduces the dense-evaluator
    fit on narrow data — including the validation-snapshot path."""
    from ranklib_tpu.models.adarank import AdaRank

    scorer = create_scorer("NDCG@10")
    csr = read_letor_sparse(sparse_file, quiet=True)
    val = synth_dataset(n_queries=4, n_features=9, min_docs=5, max_docs=12,
                        gmax=2, seed=205, w_seed=201)
    d = AdaRank(n_rounds=8)
    d.fit(csr, scorer, val)
    monkeypatch.setenv("RANKLIB_TPU_DEVICE_DENSE_MB", "0")
    s = AdaRank(n_rounds=8)
    s.fit(csr, scorer, val)
    assert [x[0] for x in d.history] == [x[0] for x in s.history]
    assert len(d.history) == len(s.history) > 0
    for (f1, a1), (f2, a2) in zip(d.history, s.history):
        assert abs(a1 - a2) < 2e-5


@pytest.mark.slow
def test_adarank_wide_sparse_trains(tmp_path):
    """-ranker 3 on a 50K-feature sparse file: the dense evaluator would
    need [N, F] blocks + a [F, F] candidate matrix; the sparse route
    builds S from present (query, feature) pairs only."""
    from ranklib_tpu.models.adarank import AdaRank
    from ranklib_tpu.ops.sparse_eval import wants_sparse_eval

    rng = np.random.default_rng(0)
    path = str(tmp_path / "wide50k_ada.txt")
    F, n_q, n_d = 50_000, 40, 30
    with open(path, "w") as f:
        for q in range(n_q):
            for _ in range(n_d):
                fids = np.unique(rng.integers(1, F + 1, 10))
                pairs = " ".join(f"{fid}:{rng.normal():.4g}"
                                 for fid in fids)
                f.write(f"{int(rng.integers(0, 3))} qid:{q + 1} {pairs}\n")
    csr = read_letor_sparse(path, quiet=True)
    import os as _os
    _os.environ["RANKLIB_TPU_DEVICE_DENSE_MB"] = "64"
    try:
        assert wants_sparse_eval(csr)
        r = AdaRank(n_rounds=5)
        r.fit(csr, create_scorer("NDCG@10"))
    finally:
        del _os.environ["RANKLIB_TPU_DEVICE_DENSE_MB"]
    assert r.weights is not None and len(r.history) >= 1


@pytest.mark.parametrize("cls_name", ["RankNet", "ListNet"])
def test_neural_sparse_first_layer_parity(sparse_file, monkeypatch,
                                          cls_name):
    """The sparse-first-layer route (gather/segment-sum x @ W1)
    reproduces the dense fit to f32 reduction-order noise."""
    import ranklib_tpu.models.neural as nn

    cls = getattr(nn, cls_name)
    scorer = create_scorer("NDCG@10")
    csr = read_letor_sparse(sparse_file, quiet=True)
    d = cls(n_epoch=3, learning_rate=0.001)
    d.fit(csr, scorer)
    monkeypatch.setenv("RANKLIB_TPU_DEVICE_DENSE_MB", "0")
    s = cls(n_epoch=3, learning_rate=0.001)
    s.fit(csr, scorer)
    for (Wd, bd), (Ws, bs) in zip(d.params, s.params):
        np.testing.assert_allclose(Ws, Wd, atol=1e-6)
        np.testing.assert_allclose(bs, bd, atol=1e-6)


@pytest.mark.slow
def test_neural_wide_sparse_trains(tmp_path):
    """-ranker 1 on a 50K-feature sparse file through the sparse first
    layer (the dense route would hold [B, D, 50K] blocks in HBM)."""
    from ranklib_tpu.models.neural import RankNet
    from ranklib_tpu.ops.sparse_eval import wants_sparse_eval

    rng = np.random.default_rng(0)
    path = str(tmp_path / "wide50k_nn.txt")
    F, n_q, n_d = 50_000, 40, 30
    with open(path, "w") as f:
        for q in range(n_q):
            for _ in range(n_d):
                fids = np.unique(rng.integers(1, F + 1, 10))
                pairs = " ".join(f"{fid}:{rng.normal():.4g}"
                                 for fid in fids)
                f.write(f"{int(rng.integers(0, 3))} qid:{q + 1} {pairs}\n")
    csr = read_letor_sparse(path, quiet=True)
    import os as _os
    _os.environ["RANKLIB_TPU_DEVICE_DENSE_MB"] = "64"
    try:
        assert wants_sparse_eval(csr)
        r = RankNet(n_epoch=3)
        r.fit(csr, create_scorer("NDCG@10"))
    finally:
        del _os.environ["RANKLIB_TPU_DEVICE_DENSE_MB"]
    assert all(np.isfinite(W).all() for W, _ in r.params)


def test_sparse_qrel_error_not_misdiagnosed(tmp_path, sparse_desc_file,
                                            capsys):
    """A qrel problem under -sparse is a real error, not a
    loader-applicability signal: no '[-sparse] ... not applicable'
    fallback log, the qrel error surfaces directly (review finding)."""
    from ranklib_tpu.cli import main as cli_main

    bad = tmp_path / "empty.qrel"
    bad.write_text("")                       # no judgments at all
    rc = cli_main(["-train", sparse_desc_file, "-ranker", "6", "-tree",
                   "2", "-leaf", "3", "-metric2t", "NDCG@10", "-sparse",
                   "-missingZero", "-qrel", str(bad)])
    out = capsys.readouterr()
    assert rc != 0
    assert "No judgments read" in out.out + out.err
    assert "not applicable" not in out.out + out.err


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_eval_layer_property(seed):
    """Property: sparse_mean_metric == the dense evaluator's mean_metric
    for random CSR data and random candidate matrices (gather/segment-sum
    vs dense matmul — reduction orders differ, so 1e-5)."""
    import tempfile

    from ranklib_tpu.ops.batched_eval import LinearMetricEvaluator
    from ranklib_tpu.ops.sparse_eval import (
        build_sparse_data, sparse_mean_metric,
    )

    rng = np.random.default_rng(seed)
    ds = synth_dataset(n_queries=10, n_features=13, min_docs=4,
                       max_docs=18, gmax=2, seed=300 + seed)
    path = tempfile.mktemp(suffix=".txt")
    _write_sparse_letor(ds, path, keep_prob=0.3, seed=seed)
    csr = read_letor_sparse(path, quiet=True)
    os.unlink(path)
    scorer = create_scorer(["NDCG@10", "ERR@10", "MAP"][seed % 3])
    W = rng.normal(size=(csr.n_features, 7)).astype(np.float32)
    dense_vals = LinearMetricEvaluator(csr, scorer).mean_metric(W)
    chunks, buckets, N = build_sparse_data(csr)
    import jax.numpy as jnp
    sparse_vals = np.asarray(sparse_mean_metric(
        scorer, jnp.asarray(W), chunks, buckets, N, len(csr.queries)))
    np.testing.assert_allclose(sparse_vals, dense_vals, atol=1e-5)


def test_kcv_sparse_rf_matches_dense(tmp_path, sparse_file):
    """-ranker 8 -sparse -kcv: RF fold models byte-equal the dense
    pipeline's through the per-fold grid flow (RF joined the streamed
    gates in the round-4 review pass)."""
    from ranklib_tpu.cli import main as cli_main

    outs = {}
    for tag, extra in (("dense", []), ("sparse", ["-sparse"])):
        d = str(tmp_path / f"kcvrf_{tag}")
        cli_main(["-train", sparse_file, "-ranker", "8", "-bag", "2",
                  "-tree", "2", "-leaf", "3", "-kcv", "3", "-tc", "8",
                  "-metric2t", "NDCG@10", "-missingZero",
                  "-kcvmd", d, "-kcvmn", "m", *extra])
        outs[tag] = "".join(
            open(os.path.join(d, f"f{i + 1}.m")).read() for i in range(3))
    assert outs["dense"] == outs["sparse"]


def test_csr_iter_buckets_host_peak_one_chunk(tmp_path, monkeypatch):
    """iter_buckets on CSR must hold ONE dense chunk at a time (review
    finding: the eager bucket list kept every chunk alive, so peak host
    memory was the full dense matrix)."""
    import tracemalloc

    from ranklib_tpu.data.dataset import iter_buckets

    rng = np.random.default_rng(2)
    F, Q, D = 2000, 40, 40                  # dense [1600, 2000] = 12.8 MB
    path = str(tmp_path / "wide.txt")
    with open(path, "w") as f:
        for q in range(Q):
            for _ in range(D):
                fids = np.unique(rng.integers(1, F + 1, 8))
                pairs = " ".join(f"{fid}:{rng.normal():.4g}"
                                 for fid in fids)
                f.write(f"{rng.integers(0, 3)} qid:{q} {pairs}\n")
    csr = read_letor_sparse(path, quiet=True)
    dense_bytes = csr.n_docs * F * 4
    monkeypatch.setenv("RANKLIB_TPU_SPARSE_CHUNK_MB", "1")
    tracemalloc.start()
    for b in iter_buckets(csr):
        assert b.feats.shape[2] == F
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak < dense_bytes / 3, (peak, dense_bytes)


def test_csr_with_width_narrow_then_widen_is_destructive(sparse_file):
    """Narrowing with_width physically drops clipped entries like the
    dense pipeline's column slice: re-widening must NOT resurrect them
    (review finding, round 5 — a metadata-only narrow re-admitted raw,
    unnormalized values)."""
    from ranklib_tpu.data.sparse import normalize_csr

    csr = read_letor_sparse(sparse_file, quiet=True)
    w = csr.n_features - 3
    back = csr.with_width(w).with_width(csr.n_features)
    got = back.materialize_rows(0, back.n_docs)
    want = csr.materialize_rows(0, csr.n_docs)
    want[:, w:] = 0.0                      # dense clip-then-pad reads 0
    np.testing.assert_array_equal(got, want)
    # normalized variant: the narrow drops the wide columns' stats too
    back_n = (normalize_csr(csr, "zscore").with_width(w)
              .with_width(csr.n_features))
    got_n = back_n.materialize_rows(0, back_n.n_docs)
    assert np.all(got_n[:, w:] == 0.0)


def test_binned_from_csr_numpy_fallback_nan_minmax(tmp_path, monkeypatch):
    """The numpy fallback's threshold grid must ignore NaN in min/max
    exactly like compute_thresholds (review finding, round 5: np.unique
    sorts NaN last, so (u[0], u[-1]) poisoned the linspace grid for any
    over-cap feature containing a NaN)."""
    import ranklib_tpu.native.loader as L
    from ranklib_tpu.data.binned import binned_from_csr

    rng = np.random.default_rng(3)
    lines = []
    n_docs = 60
    for i in range(n_docs):
        # feature 1: > tc distinct values plus NaN rows
        v = "nan" if i % 7 == 0 else f"{rng.normal():.6f}"
        lines.append(f"{i % 3} qid:{i // 10 + 1} 1:{v} 2:{i % 4}")
    p = tmp_path / "nan.txt"
    p.write_text("\n".join(lines) + "\n")
    csr = read_letor_sparse(str(p), quiet=True)
    monkeypatch.setattr(L, "native_feature_uniques", lambda *a, **k: None)
    ds = binned_from_csr(csr, n_threshold=8)
    grid = ds.thresholds[0]
    assert np.isfinite(grid[np.isfinite(grid)]).all()
    finite = grid[~np.isinf(grid)]
    assert len(finite) > 1 and not np.isnan(finite).any()
    # the grid must span the finite value range, not collapse to NaN
    assert np.all(np.diff(finite) > 0)
