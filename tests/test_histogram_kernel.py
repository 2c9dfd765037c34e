"""The segment-sum histogram (ops/histogram.py) and the split scan:
float64 ground truth, bag batching, bin-storage widths, masks, and the
subtraction trick. Counts must agree exactly, float sums to f32
rounding."""

import jax.numpy as jnp
import numpy as np
import pytest

from ranklib_tpu.ops.histogram import hist_multi_xla, hist_xla


def jnp_arr(x):
    return jnp.asarray(x)


def _case(N, F, B, seed, mask_frac=0.3):
    rng = np.random.default_rng(seed)
    binned_T = rng.integers(0, B, size=(F, N)).astype(np.int32)
    grad = rng.normal(size=N).astype(np.float32)
    mask = rng.random(N) > mask_frac
    return binned_T, grad, mask


def _numpy_hist(binned_T, grad, weight, B):
    """float64 ground truth; ids >= B count nowhere."""
    F = binned_T.shape[0]
    out = np.zeros((F, B, 2))
    for f in range(F):
        keep = binned_T[f] < B
        out[f, :, 0] = np.bincount(binned_T[f][keep],
                                   (grad * weight)[keep], minlength=B)
        out[f, :, 1] = np.bincount(binned_T[f][keep], weight[keep],
                                   minlength=B)
    return out


def test_out_of_range_bins_ignored_by_xla_path():
    binned_T = np.array([[0, 7, 8, 9]], np.int32)       # 8,9 out of range
    grad = np.ones(4, np.float32)
    mask = np.ones(4, bool)
    h = np.asarray(hist_xla(jnp_arr(binned_T), grad, mask, 8))
    assert h[0, 0, 1] == 1 and h[0, 7, 1] == 1
    assert h[..., 1].sum() == 2


def test_multi_bag_xla_matches_per_bag():
    rng = np.random.default_rng(2)
    N, F, B, C = 400, 5, 16, 4
    binned = jnp.asarray(rng.integers(0, B, size=(F, N)).astype(np.int32))
    grads = jnp.asarray(rng.normal(size=(C, N)).astype(np.float32))
    w = jnp.asarray((rng.random((C, N)) > 0.3).astype(np.float32))
    got = np.asarray(hist_multi_xla(binned, grads, w, B))
    for c in range(C):
        want = np.asarray(hist_xla(binned, grads[c], w[c], B))
        np.testing.assert_allclose(got[c], want, atol=1e-5)


def test_subtraction_trick_property():
    """parent_hist − right_child_hist == left_child_hist computed directly
    (the reference's FeatureHistogram construct-from-parent/sibling)."""
    rng = np.random.default_rng(7)
    N, F, B = 512, 5, 8
    binned_T = rng.integers(0, B, size=(F, N)).astype(np.int32)
    grad = rng.normal(size=N).astype(np.float32)
    parent = rng.random(N) > 0.2                   # parent members
    right = parent & (rng.random(N) > 0.5)
    left = parent & ~right
    hp = np.asarray(hist_xla(jnp.asarray(binned_T), grad, parent, B))
    hr = np.asarray(hist_xla(jnp.asarray(binned_T), grad, right, B))
    hl = np.asarray(hist_xla(jnp.asarray(binned_T), grad, left, B))
    np.testing.assert_allclose(hp - hr, hl, atol=1e-4)


def test_split_scan_matches_bruteforce():
    """best_splits vs an explicit double loop over (feature, bin): mls
    filtering, feature masks, empty (all-zero) children, and the
    feature-major first-max tie order."""
    from ranklib_tpu.ops.split_scan import best_splits

    rng = np.random.default_rng(5)
    for trial in range(4):
        Cn, F, B = 2, 7, 16
        counts = rng.integers(0, 5, (Cn, F, B)).astype(np.float64)
        counts[:] = counts[:, :1, :]        # every feature bins every doc
        sums = rng.normal(size=(Cn, F, B)) * counts.astype(bool)
        if trial == 2:
            counts[1] = 0                    # empty child
            sums[1] = 0
        if trial == 3:
            sums[0, 4] = sums[0, 2]          # an exact tie across features
        fmask = rng.random((Cn, F)) > 0.2
        mls = [1.0, 3.0, 1.0, 2.0][trial]
        hist = jnp.asarray(np.stack([sums, counts], axis=-1), jnp.float32)
        g, f, b, ok = (np.asarray(x) for x in best_splits(
            hist, mls, jnp.asarray(fmask)))
        h32 = np.asarray(hist, np.float64)
        for c in range(Cn):
            best, arg = -np.inf, None
            for ff in range(F):
                if not fmask[c, ff]:
                    continue
                cl = np.cumsum(h32[c, ff, :, 1])
                sl = np.cumsum(h32[c, ff, :, 0])
                for bb in range(B):
                    cr, sr = cl[-1] - cl[bb], sl[-1] - sl[bb]
                    if cl[bb] < mls or cr < mls:
                        continue
                    gain = sl[bb] ** 2 / cl[bb] + sr ** 2 / cr
                    if gain > best * (1 + 1e-6) + 1e-9:
                        best, arg = gain, (ff, bb)
            assert bool(ok[c]) == (arg is not None), trial
            if arg is not None:
                np.testing.assert_allclose(g[c], best, rtol=1e-5)
                assert (int(f[c]), int(b[c])) == arg, trial


def test_bins_dtype_invariance():
    """uint8 / int16 / int32 bin matrices produce identical histograms
    and identical trees. Pins the weak-literal footgun: `uint8 < 256`
    casts the literal INTO uint8 (wrapping to 0) and silently zeroed the
    hist_xla keep mask when uint8 device storage landed."""
    from ranklib_tpu.gbdt.grow import grow_tree

    rng = np.random.default_rng(0)
    bt32 = jnp.asarray(rng.integers(0, 256, (5, 500)), jnp.int32)
    g = jnp.asarray(rng.normal(size=(500,)), jnp.float32)
    m = jnp.asarray(rng.random(500) < 0.9)
    ref_h = hist_xla(bt32, g, m, 256)
    ref_t = grow_tree(bt32, g, n_bins=256, n_leaves=4, doc_mask=m)
    for dt in (jnp.uint8, jnp.int16):
        bt = bt32.astype(dt)
        np.testing.assert_array_equal(hist_xla(bt, g, m, 256), ref_h)
        t = grow_tree(bt, g, n_bins=256, n_leaves=4, doc_mask=m)
        np.testing.assert_array_equal(t.feature, ref_t.feature)
        np.testing.assert_array_equal(t.bin, ref_t.bin)
        np.testing.assert_array_equal(t.node_of_doc, ref_t.node_of_doc)


@pytest.mark.parametrize("B", [11, 128, 256])
@pytest.mark.parametrize("C", [1, 3])
def test_hist_xla_matches_float64(B, C):
    """The XLA reference itself against float64 bincounts, for the bin
    widths training meets (RankBoost's T+1 = 11, near-categorical 128,
    the default 256) and 1 or several bags with integer weights."""
    rng = np.random.default_rng(B * 10 + C)
    N, F = 700, 6
    binned = rng.integers(0, B, size=(F, N)).astype(np.int32)
    grads = rng.normal(size=(C, N)).astype(np.float32)
    w = rng.integers(0, 3, size=(C, N)).astype(np.float32)
    got = np.asarray(hist_multi_xla(jnp_arr(binned), jnp_arr(grads),
                                    jnp_arr(w), B))
    for c in range(C):
        want = _numpy_hist(binned, grads[c].astype(np.float64),
                           w[c].astype(np.float64), B)
        np.testing.assert_array_equal(got[c, ..., 1], want[..., 1])
        np.testing.assert_allclose(got[c, ..., 0], want[..., 0],
                                   atol=1e-4, rtol=1e-5)


def test_all_masked_gives_zero():
    binned, grad, _ = _case(256, 4, 8, seed=0)
    got = np.asarray(hist_xla(jnp_arr(binned), grad, np.zeros(256, bool), 8))
    assert (got == 0).all()


def test_masked_stretches_match_float64():
    """A child node's mask zeroes long stretches of docs; the rest must
    still be counted exactly."""
    binned, grad, _ = _case(2000, 4, 64, seed=4)
    mask = np.zeros(2000, bool)
    mask[300:500] = True
    mask[1900:] = True
    got = np.asarray(hist_xla(jnp_arr(binned), grad, mask, 64))
    want = _numpy_hist(binned, grad.astype(np.float64),
                       mask.astype(np.float64), 64)
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got[..., 0], want[..., 0], atol=1e-4,
                               rtol=1e-5)
