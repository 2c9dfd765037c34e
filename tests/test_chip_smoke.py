"""chip_smoke.py's pure helpers, its refusal without a GPU, and the
compiled-kernel check that only runs on the card (``gpu`` marker)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_parse_smi_one_card():
    assert cs.parse_smi("NVIDIA H100 80GB HBM3, 700.00 W\n") == [
        ("NVIDIA H100 80GB HBM3", "700.00 W")]


def test_parse_smi_four_cards_and_commas_in_name():
    text = "\n".join(["NVIDIA H100, 80GB HBM3, 400.00 W"] * 4)
    got = cs.parse_smi(text)
    assert len(got) == 4
    assert got[0] == ("NVIDIA H100, 80GB HBM3", "400.00 W")


def test_parse_smi_rejects_garbage():
    with pytest.raises(ValueError):
        cs.parse_smi("no comma here")


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_shape(count):
    line = cs.result_line("NVIDIA H100 80GB HBM3", count)
    assert "\n" not in line
    obj = json.loads(line)
    assert obj == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def test_parse_test_ndcg_and_missing():
    assert cs.parse_test_ndcg("x\nNDCG@10 on test data: 0.4321\n") == 0.4321
    with pytest.raises(cs.SmokeFailure):
        cs.parse_test_ndcg("NDCG@10 on training data: 0.5")


def test_write_letor_round_trips(tmp_path):
    from ranklib_tpu.data.letor import read_letor
    from tests.fixtures import synth_dataset

    ds = synth_dataset(n_queries=3, n_features=7, seed=2)
    p = tmp_path / "d.txt"
    cs.write_letor(ds, str(p))
    back = read_letor(str(p), quiet=True)
    assert [q.qid for q in back.queries] == [q.qid for q in ds.queries]
    for a, b in zip(back.queries, ds.queries):
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_allclose(a.feats, b.feats, rtol=1e-5)


def test_refuses_without_gpu_and_prints_no_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(_REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs an NVIDIA GPU" in p.stderr


@pytest.mark.gpu
def test_scoring_kernel_compiled_matches_traversal():
    import jax.numpy as jnp

    import __graft_entry__ as g
    from ranklib_tpu.gbdt.ensemble import _ensemble_eval
    from ranklib_tpu.ops.forest_eval import forest_eval_triton

    ens = g._synthetic_ensemble(n_trees=200, n_leaves=10, n_features=136,
                                rng=np.random.default_rng(0))
    X = jnp.asarray(np.random.default_rng(1).normal(
        size=(5000, 136)).astype(np.float32))
    fe, th, lf, rt, lv, ot, wt, depth = ens._pack()
    want = np.asarray(_ensemble_eval(X, fe, th, lf, rt, lv, ot, wt,
                                     depth=depth))
    got = np.asarray(forest_eval_triton(X, *ens._pack_kernel()))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
