"""Native C++ LETOR parser vs the Python reference parser: exact parity
on labels, features, qids, query grouping, and descriptions."""

import gzip

import numpy as np
import pytest

from ranklib_tpu.data.letor import read_letor
from ranklib_tpu.native.loader import native_available, native_parse_letor

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="no C++ toolchain")

SAMPLE = """\
# comment line to skip
2 qid:10 1:0.5 3:-1.25 # docA
0 qid:10 2:1e-3 5:4 # docB

1 qid:20 1:2 2:3 3:4 4:5 5:6 # docC
0 qid:20 3:0.125
2 qid:10 1:7 # second block of qid 10 is a NEW query (consecutive grouping)
"""


def _write(tmp_path, text, name="data.txt"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def test_native_matches_python(tmp_path):
    path = _write(tmp_path, SAMPLE)
    a = read_letor(path, quiet=True, use_native=False)
    b = read_letor(path, quiet=True, use_native=True)
    assert len(a.queries) == len(b.queries) == 3
    assert a.n_features == b.n_features == 5
    for qa, qb in zip(a.queries, b.queries):
        assert qa.qid == qb.qid
        np.testing.assert_array_equal(qa.labels, qb.labels)
        np.testing.assert_array_equal(np.asarray(qa.feats), np.asarray(qb.feats))
        assert qa.descs == qb.descs


def test_native_direct_outputs(tmp_path):
    path = _write(tmp_path, SAMPLE)
    labels, feats, qptr, qids, descs, counts, max_fid = native_parse_letor(path)
    assert qids == ["10", "20", "10"]
    np.testing.assert_array_equal(qptr, [0, 2, 4, 5])
    np.testing.assert_array_equal(labels, [2, 0, 1, 0, 2])
    assert feats.shape == (5, 5)
    assert feats[0, 0] == 0.5 and feats[0, 2] == -1.25
    assert feats[1, 1] == pytest.approx(1e-3)
    assert feats[3, 2] == 0.125 and feats[3, 0] == 0.0   # missing → 0
    assert descs[0] == "# docA" and descs[3] == ""
    np.testing.assert_array_equal(counts, [2, 2, 5, 1, 1])
    assert max_fid == 5


def test_native_rejects_malformed_falls_back(tmp_path):
    from ranklib_tpu.utils.errors import RankLibError
    path = _write(tmp_path, "1 qid:1 bogus\n")
    with pytest.raises(RankLibError):
        read_letor(path, quiet=True, use_native=True)


def test_gzip_falls_back_to_python(tmp_path):
    p = tmp_path / "data.txt.gz"
    with gzip.open(p, "wt") as f:
        f.write("1 qid:1 1:0.5\n0 qid:1 1:0.25\n")
    ds = read_letor(str(p), quiet=True, use_native=True)
    assert len(ds.queries) == 1 and ds.queries[0].n == 2


def test_large_file_speed_parity(tmp_path):
    rng = np.random.default_rng(0)
    lines = []
    for q in range(200):
        for d in range(30):
            feats = " ".join(f"{j + 1}:{rng.normal():.5f}" for j in range(46))
            lines.append(f"{int(rng.integers(0, 3))} qid:{q} {feats} # doc{q}_{d}")
    path = _write(tmp_path, "\n".join(lines) + "\n", "big.txt")
    a = read_letor(path, quiet=True, use_native=False)
    b = read_letor(path, quiet=True, use_native=True)
    assert a.n_docs == b.n_docs == 6000
    fa = np.concatenate([q.feats for q in a.queries])
    fb = np.concatenate([np.asarray(q.feats) for q in b.queries])
    np.testing.assert_allclose(fa, fb, rtol=1e-6)


def test_adversarial_format_parity(tmp_path):
    """Fuzz the parsers with every LETOR formatting quirk at once:
    scientific/negative exponents, tabs and runs of spaces, CRLF, bare
    and trailing comments, fid gaps (missing-as-zero), unsorted fids,
    float labels, blank lines."""
    rng = np.random.default_rng(9)
    lines = ["# header comment", ""]
    for qi in range(12):
        for _ in range(int(rng.integers(1, 6))):
            fids = rng.permutation(9)[: rng.integers(1, 6)] + 1
            feats = " ".join(
                f"{f}:{v:.6g}" for f, v in zip(
                    fids, rng.normal(scale=10.0 ** rng.integers(-8, 6),
                                     size=len(fids))))
            sep = "\t" if rng.random() < 0.3 else "   "
            comment = " # doc αβ" if rng.random() < 0.5 else ""
            lines.append(f"{int(rng.integers(0, 5))} qid:{100 + qi}"
                         f"{sep}{feats}{comment}")
        if rng.random() < 0.3:
            lines.append("")
    text = "\r\n".join(lines) + "\r\n"
    p = tmp_path / "fuzz.txt"
    p.write_bytes(text.encode())

    ds_native = read_letor(str(p), quiet=True, use_native=True)
    ds_python = read_letor(str(p), quiet=True, use_native=False)
    assert len(ds_native.queries) == len(ds_python.queries)
    assert ds_native.n_features == ds_python.n_features
    for a, b in zip(ds_native.queries, ds_python.queries):
        assert a.qid == b.qid and a.n == b.n
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_allclose(a.feats, b.feats, rtol=1e-6, atol=0)


def test_native_binner_matches_numpy_exactly():
    """The C++ binner must reproduce np.searchsorted(side='left') bit-for-
    bit: ties on exact threshold values, +inf padding, values above max."""
    from ranklib_tpu.native.loader import native_bin_features

    rng = np.random.default_rng(11)
    N, F, B = 4096, 13, 77
    thr = np.sort(rng.normal(size=(F, B)).astype(np.float32), axis=1)
    thr[:, -1] = np.inf
    feats = rng.normal(size=(N, F)).astype(np.float32)
    feats[::5] = thr[np.arange(F), rng.integers(0, B, F)]   # exact hits
    feats[::11] = 1e9                                        # above max
    got = native_bin_features(feats, thr)
    if got is None:
        pytest.skip("native binner unavailable (no compiler)")
    ref = np.empty((N, F), np.int32)
    for f in range(F):
        ref[:, f] = np.searchsorted(thr[f], feats[:, f], side="left")
    assert np.array_equal(got, ref)


def test_native_thresholds_match_numpy_exactly():
    """compute_thresholds via the capped-hash C++ uniques pass must equal
    the np.unique path exactly: categorical (<=tc uniques), constant
    (-0.0/0.0 fold), heavy ties, and >tc continuous features."""
    import ranklib_tpu.native.loader as L
    from ranklib_tpu.gbdt.binning import compute_thresholds

    if L.native_feature_uniques(np.zeros((4, 2), np.float32), 8) is None:
        pytest.skip("native binner unavailable (no compiler)")
    rng = np.random.default_rng(3)
    N, F = 20000, 12
    feats = rng.normal(size=(N, F)).astype(np.float32)
    feats[:, 1] = rng.integers(0, 5, N)
    feats[:, 2] = 0.0
    feats[: N // 2, 2] = -0.0
    feats[:, 3] = rng.integers(0, 300, N)
    feats[:, 4] = np.round(feats[:, 4], 1)

    thr_nat, nb_nat = compute_thresholds(feats, 256)
    orig = L.native_feature_uniques
    L.native_feature_uniques = lambda *a, **k: None
    try:
        thr_np, nb_np = compute_thresholds(feats, 256)
    finally:
        L.native_feature_uniques = orig
    assert np.array_equal(thr_nat, thr_np)
    assert np.array_equal(nb_nat, nb_np)


def test_native_parser_handles_gzip_via_temp_decompress(tmp_path):
    """Gzip inputs keep the native path (decompress to a temp file) and
    must match the plain-file parse exactly."""
    import gzip

    from ranklib_tpu.data.letor import read_letor
    from ranklib_tpu.native.loader import native_available
    from tests.fixtures import synth_dataset, write_letor_text

    if not native_available():
        pytest.skip("native parser unavailable")
    ds = synth_dataset(n_queries=12, n_features=5, seed=8, signal=2.0)
    plain = str(tmp_path / "t.txt")
    gz = str(tmp_path / "t.txt.gz")
    write_letor_text(ds, plain)
    with open(plain, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    a = read_letor(plain, quiet=True)
    b = read_letor(gz, quiet=True)
    assert len(a.queries) == len(b.queries)
    for qa, qb in zip(a.queries, b.queries):
        assert qa.qid == qb.qid
        assert np.array_equal(qa.feats, qb.feats)
        assert np.array_equal(qa.labels, qb.labels)


def test_oversized_qid_and_desc_fall_back_exactly(tmp_path):
    """qids > 63 chars / descriptions > 159 chars exceed the native
    buffers: the C++ pass must signal capacity (never silently truncate)
    and read_letor must deliver the Python parser's exact strings."""
    long_a = "q" * 70 + "A"
    long_b = "q" * 70 + "B"      # same 63-char prefix — must NOT merge
    big_desc = "# " + "d" * 400
    text = (f"2 qid:{long_a} 1:1 2:2\n"
            f"0 qid:{long_a} 1:3 2:4\n"
            f"1 qid:{long_b} 1:5 2:6\n")
    path = _write(tmp_path, text, "longqid.txt")
    with pytest.raises(Exception):
        native_parse_letor(path)
    ds = read_letor(path)
    assert [q.qid for q in ds.queries] == [long_a, long_b]

    text2 = f"1 qid:1 1:1 {big_desc}\n0 qid:1 1:2\n"
    path2 = _write(tmp_path, text2, "longdesc.txt")
    with pytest.raises(Exception):
        native_parse_letor(path2)
    ds2 = read_letor(path2)
    assert ds2.queries[0].descs[0] == big_desc

    # at-capacity strings (63-char qid, 159-char desc) stay on the
    # native path, byte-exact
    q63 = "x" * 63
    d159 = "#" + "e" * 158
    text3 = f"1 qid:{q63} 1:1 {d159}\n"
    path3 = _write(tmp_path, text3, "edge.txt")
    out = native_parse_letor(path3)
    assert out is not None
    assert out[3] == [q63] and out[4][0] == d159
