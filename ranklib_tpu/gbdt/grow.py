"""Fully-jitted leaf-wise regression tree growth.

Reference behavior (learning/tree/RegressionTree.java:~60 +
FeatureHistogram.findBestSplit:~300):

* best-first growth: a queue of leaves sorted by node deviance
  (Σg² − S²/c); each step pops the highest-deviance leaf and applies its
  best split until ``nLeaves`` leaves exist or nothing is splittable;
* a split candidate (feature f, bin b) is valid iff both sides hold at
  least ``minLeafSupport`` docs; among valid candidates the split
  maximizing S_L²/c_L + S_R²/c_R wins, first (feature-major) max on ties;
* child histograms come from the subtraction trick: build the smaller…
  (here: right) child directly, derive the sibling as parent − child
  (ref: FeatureHistogram construct-from-parent/sibling:~150).

Accelerator shape: the whole growth loop is one ``lax.fori_loop`` under jit
over fixed-size node arrays of ``M = 2·nLeaves − 1`` slots. Doc→leaf
assignment is an ``[N]`` int array updated by masked select per split; the
histogram is a 2-channel (Σgrad, count) ``[F, B]`` masked segment-sum.
XLA needs static shapes — dynamic index lists (the reference's
``Split.getSamples``) do not exist here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ranklib_tpu.ops.histogram import hist_multi_xla, hist_xla
from ranklib_tpu.ops.split_scan import best_splits


class TreeArrays(NamedTuple):
    """One grown tree in flat-slot form. Slot 0 is the root; unused slots
    (when growth stopped early) have is_leaf=False and left=right=-1."""

    feature: jnp.ndarray      # [M] int32 split feature (col index, 0-based)
    bin: jnp.ndarray          # [M] int32 split bin (go left iff bin_d <= bin)
    left: jnp.ndarray         # [M] int32 child slot (-1 on leaves)
    right: jnp.ndarray        # [M] int32
    is_leaf: jnp.ndarray      # [M] bool
    n_nodes: jnp.ndarray      # [] int32 slots in use
    node_of_doc: jnp.ndarray  # [N] int32 leaf slot of each training doc
    impacts: jnp.ndarray      # [F] f32 deviance reduction per split feature


def _split1(hist, mls, fmask=None):
    """Best split of ONE node's histogram [F, B, 2] → (gain, f, b, ok).
    Maximizes S_L²/c_L + S_R²/c_R over candidates with both sides >=
    minLeafSupport; first max wins on ties (feature-major order, matching
    the reference's scan order — FeatureHistogram.findBestSplit:~300).
    Computed by ops.split_scan."""
    g, f, b, ok = best_splits(
        hist[None], mls, None if fmask is None else fmask[None])
    return g[0], f[0], b[0], ok[0]


@functools.partial(
    jax.jit,
    static_argnames=("n_bins", "n_leaves", "min_leaf_support", "axis_name"))
def grow_tree(binned_T, grad, n_bins: int, n_leaves: int,
              min_leaf_support: int = 1, doc_mask=None,
              axis_name: str | None = None,
              feature_mask=None) -> TreeArrays:
    """Grow one regression tree on pseudo-responses ``grad``.

    binned_T: [F, N] int32 pre-binned features, FEATURE-MAJOR (docs on the
    minor axis; split-column reads become row gathers); grad: [N]
    float32.

    doc_mask: optional [N] bool mask OR f32 doc weights — weight 0 (or
    False) excludes a doc from every histogram and count; integer weights
    encode with-replacement multiplicity (RF bags), equivalent to
    physically duplicating the doc's rows.

    axis_name: when set, the docs axis is sharded over that mesh axis and
    every histogram / node statistic is all-reduced with ``lax.psum`` —
    split decisions then replicate deterministically on all devices (the
    data-parallel counterpart of the reference's MyThreadPool feature
    partitioning,
    SURVEY.md §5 communication row: GBDT data-parallel scales because
    histograms are tiny).
    """
    F, N = binned_T.shape
    M = 2 * n_leaves - 1
    mls = float(min_leaf_support)
    B = int(n_bins)

    def allr(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    dw = (jnp.ones((N,), jnp.float32) if doc_mask is None
          else doc_mask.astype(jnp.float32))
    root_hist = allr(hist_xla(binned_T, grad, dw, B))
    S0 = jnp.sum(root_hist[0, :, 0])       # feature 0 bins every doc once
    SQ0 = allr(jnp.sum(dw * grad * grad))
    C0 = jnp.sum(root_hist[0, :, 1])
    g0, f0, b0, ok0 = _split1(root_hist, mls, feature_mask)

    hist = jnp.zeros((M, F, B, 2), jnp.float32).at[0].set(root_hist)
    stats = jnp.zeros((M, 3), jnp.float32).at[0].set(jnp.stack([S0, SQ0, C0]))
    # root deviance = +inf: the reference seeds the root with
    # Float.MAX_VALUE so it is always popped first
    deviance = jnp.full((M,), -jnp.inf).at[0].set(jnp.inf)
    best_gain = jnp.zeros((M,)).at[0].set(g0)
    best_f = jnp.zeros((M,), jnp.int32).at[0].set(f0)
    best_b = jnp.zeros((M,), jnp.int32).at[0].set(b0)
    splittable = jnp.zeros((M,), bool).at[0].set(ok0)

    feature = jnp.full((M,), -1, jnp.int32)
    sbin = jnp.full((M,), -1, jnp.int32)
    left = jnp.full((M,), -1, jnp.int32)
    right = jnp.full((M,), -1, jnp.int32)
    is_leaf = jnp.zeros((M,), bool).at[0].set(True)
    node_of_doc = jnp.zeros((N,), jnp.int32)
    n_nodes = jnp.int32(1)
    impacts = jnp.zeros((F,), jnp.float32)

    # The LAST iteration's children can never be popped (the loop ends),
    # so their histograms / stats / split scans are dead work. That final
    # iteration is PEELED as a static build_children=False instantiation
    # of the body (pop + assign + record only) — saving one full histogram
    # pass per tree, ~11% of the round at n_leaves=10. (A runtime
    # lax.cond was tried instead and measured 31× slower: the cond's
    # captured buffers broke XLA's in-place reuse inside the loop.)
    def make_body(build_children: bool):
        def body(k, st):
            (hist, stats, deviance, best_gain, best_f, best_b, splittable,
             feature, sbin, left, right, is_leaf, node_of_doc, n_nodes,
             impacts) = st

            cand = jnp.where(is_leaf & splittable, deviance, -jnp.inf)
            leaf = jnp.argmax(cand).astype(jnp.int32)
            valid = cand[leaf] > -jnp.inf

            f_s = best_f[leaf]
            b_s = best_b[leaf]
            # feature impact: deviance reduced by this split = (S_L²/c_L +
            # S_R²/c_R) − S²/c (ref: LambdaMART impacts[] accumulation)
            parent_term = jnp.where(
                stats[leaf, 2] > 0,
                stats[leaf, 0] ** 2 / jnp.maximum(stats[leaf, 2], 1.0), 0.0)
            impacts = impacts.at[f_s].add(
                jnp.where(valid, best_gain[leaf] - parent_term, 0.0))
            la = n_nodes
            ra = n_nodes + 1

            col = binned_T[f_s]                       # [N] row gather
            in_node = node_of_doc == leaf
            go_left = col <= b_s
            new_assign = jnp.where(in_node, jnp.where(go_left, la, ra),
                                   node_of_doc)
            node_of_doc = jnp.where(valid, new_assign, node_of_doc)

            def upd(arr, idx, val):
                return arr.at[idx].set(jnp.where(valid, val, arr[idx]))

            if build_children:
                # right child directly, left by subtraction (parent − sibling)
                w_r = dw * (in_node & (~go_left) & valid)
                hist_r = allr(hist_xla(binned_T, grad, w_r, B))
                hist_l = hist[leaf] - hist_r
                # S_r/C_r come from the child histogram itself (feature 0
                # bins every doc exactly once, so its rows sum the node):
                # two [B]-sized reductions replace two [N]-sized ones, and
                # the gain scan consumes sums with the same provenance as
                # its cumsums. Only SQ (grad², feeds the pop-priority
                # deviance) still needs a doc-axis pass.
                S_r = jnp.sum(hist_r[0, :, 0])
                C_r = jnp.sum(hist_r[0, :, 1])
                SQ_r = allr(jnp.sum(w_r * grad * grad))
                S_l = stats[leaf, 0] - S_r
                SQ_l = stats[leaf, 1] - SQ_r
                C_l = stats[leaf, 2] - C_r

                def dev(SQ, S, C):
                    return jnp.where(C > 0, SQ - S * S / jnp.maximum(C, 1.0),
                                     -jnp.inf)

                # ONE batched scan over both children (a [2, F, B, 2]
                # ops.split_scan.best_splits) instead of two sequential scans —
                # at this size the scan cost is mostly launch latency
                hist_lr = jnp.stack([hist_l, hist_r])
                fm2 = (None if feature_mask is None
                       else jnp.broadcast_to(feature_mask, (2, F)))
                g2, f2, b2, ok2 = best_splits(hist_lr, mls, fm2)
                g_l, f_l, b_l, ok_l = g2[0], f2[0], b2[0], ok2[0]
                g_r, f_r, b_r, ok_r = g2[1], f2[1], b2[1], ok2[1]

                hist = hist.at[la].set(jnp.where(valid, hist_l, hist[la]))
                hist = hist.at[ra].set(jnp.where(valid, hist_r, hist[ra]))
                stats = stats.at[la].set(
                    jnp.where(valid, jnp.stack([S_l, SQ_l, C_l]), stats[la]))
                stats = stats.at[ra].set(
                    jnp.where(valid, jnp.stack([S_r, SQ_r, C_r]), stats[ra]))
                deviance = upd(upd(deviance, la, dev(SQ_l, S_l, C_l)),
                               ra, dev(SQ_r, S_r, C_r))
                best_gain = upd(upd(best_gain, la, g_l), ra, g_r)
                best_f = upd(upd(best_f, la, f_l), ra, f_r)
                best_b = upd(upd(best_b, la, b_l), ra, b_r)
                splittable = upd(upd(splittable, la, ok_l), ra, ok_r)

            feature = upd(feature, leaf, f_s)
            sbin = upd(sbin, leaf, b_s)
            left = upd(left, leaf, la)
            right = upd(right, leaf, ra)
            is_leaf = upd(is_leaf, leaf, False)
            is_leaf = upd(upd(is_leaf, la, True), ra, True)
            n_nodes = n_nodes + jnp.where(valid, jnp.int32(2), jnp.int32(0))

            return (hist, stats, deviance, best_gain, best_f, best_b,
                    splittable, feature, sbin, left, right, is_leaf,
                    node_of_doc, n_nodes, impacts)

        return body

    st = (hist, stats, deviance, best_gain, best_f, best_b, splittable,
          feature, sbin, left, right, is_leaf, node_of_doc, n_nodes, impacts)
    if n_leaves > 2:
        st = jax.lax.fori_loop(0, n_leaves - 2, make_body(True), st)
    st = make_body(False)(jnp.int32(n_leaves - 2), st)
    (hist, stats, deviance, best_gain, best_f, best_b, splittable,
     feature, sbin, left, right, is_leaf, node_of_doc, n_nodes, impacts) = st
    return TreeArrays(feature, sbin, left, right, is_leaf, n_nodes,
                      node_of_doc, impacts)


@functools.partial(
    jax.jit, static_argnames=("n_bins", "n_leaves", "min_leaf_support"))
def grow_forest(binned_T, grads, n_bins: int, n_leaves: int,
                min_leaf_support: int = 1, doc_weights=None,
                feature_masks=None) -> TreeArrays:
    """Grow ``Cb`` independent regression trees in lockstep on one dataset.

    The Random-Forests work shape (learning/tree/RFRanker.java:~25): every
    bag shares the binned matrix and differs only in per-doc multiplicity
    weights and a feature mask. Growing the bags' trees together turns the
    ``Cb`` per-bag growth loops into ONE loop whose histogram pass maps
    over the bags (ops/histogram.py). Semantics are
    bag-for-bag identical to ``grow_tree`` run per bag.

    grads: [Cb, N] per-bag pseudo-responses; doc_weights: optional [Cb, N]
    (RF with-replacement multiplicities; 0 excludes); feature_masks:
    optional [Cb, F] bool. Returns TreeArrays with a leading [Cb] axis
    (node_of_doc: [Cb, N]; impacts: [Cb, F]).
    """
    F, N = binned_T.shape
    Cb = grads.shape[0]
    M = 2 * n_leaves - 1
    mls = float(min_leaf_support)
    B = int(n_bins)
    cidx = jnp.arange(Cb)

    dw = (jnp.ones((Cb, N), jnp.float32) if doc_weights is None
          else doc_weights.astype(jnp.float32))
    root_hist = hist_multi_xla(binned_T, grads, dw, B)            # [Cb,F,B,2]
    S0 = jnp.sum(dw * grads, axis=1)
    SQ0 = jnp.sum(dw * grads * grads, axis=1)
    C0 = jnp.sum(dw, axis=1)
    g0, f0, b0, ok0 = best_splits(root_hist, mls, feature_masks)

    # Leaf histograms live in an ITERATION-indexed buffer: iteration k
    # writes its two children at rows 2k+1 / 2k+2 — scalar row indices, so
    # XLA lowers the writes to in-place dynamic-update-slices inside the
    # fori_loop. Indexing the buffer by per-bag node slot instead (a
    # [Cb]-array scatter) forced XLA to copy the multi-GB buffer every
    # iteration — measured 14× slower at 100 leaves. ``hidx`` maps each
    # bag's node slot to its buffer row (bags that skip an invalid
    # iteration leave that iteration's rows unused and unreferenced).
    hist = jnp.zeros((Cb, M, F, B, 2), jnp.float32).at[:, 0].set(root_hist)
    hidx = jnp.zeros((Cb, M), jnp.int32)
    stats = jnp.zeros((Cb, M, 3), jnp.float32).at[:, 0].set(
        jnp.stack([S0, SQ0, C0], axis=1))
    deviance = jnp.full((Cb, M), -jnp.inf).at[:, 0].set(jnp.inf)
    best_gain = jnp.zeros((Cb, M)).at[:, 0].set(g0)
    best_f = jnp.zeros((Cb, M), jnp.int32).at[:, 0].set(f0)
    best_b = jnp.zeros((Cb, M), jnp.int32).at[:, 0].set(b0)
    splittable = jnp.zeros((Cb, M), bool).at[:, 0].set(ok0)

    feature = jnp.full((Cb, M), -1, jnp.int32)
    sbin = jnp.full((Cb, M), -1, jnp.int32)
    left = jnp.full((Cb, M), -1, jnp.int32)
    right = jnp.full((Cb, M), -1, jnp.int32)
    is_leaf = jnp.zeros((Cb, M), bool).at[:, 0].set(True)
    node_of_doc = jnp.zeros((Cb, N), jnp.int32)
    n_nodes = jnp.ones((Cb,), jnp.int32)
    impacts = jnp.zeros((Cb, F), jnp.float32)

    # Last iteration's children can never be popped — that iteration is
    # peeled as a static build_children=False body (see grow_tree: a
    # runtime lax.cond broke XLA's in-place buffer reuse, 31× slower).
    def make_body(build_children: bool):
        def body(k, st):
            (hist, hidx, stats, deviance, best_gain, best_f, best_b,
             splittable, feature, sbin, left, right, is_leaf, node_of_doc,
             n_nodes, impacts) = st

            cand = jnp.where(is_leaf & splittable, deviance, -jnp.inf)
            leaf = jnp.argmax(cand, axis=1).astype(jnp.int32)  # [Cb]
            valid = jnp.take_along_axis(
                cand, leaf[:, None], axis=1)[:, 0] > -jnp.inf

            f_s = best_f[cidx, leaf]
            b_s = best_b[cidx, leaf]
            pstats = stats[cidx, leaf]                         # [Cb, 3]
            parent_term = jnp.where(
                pstats[:, 2] > 0,
                pstats[:, 0] ** 2 / jnp.maximum(pstats[:, 2], 1.0), 0.0)
            impacts = impacts.at[cidx, f_s].add(
                jnp.where(valid, best_gain[cidx, leaf] - parent_term, 0.0))
            la = n_nodes
            ra = n_nodes + 1

            col = binned_T[f_s]                                # [Cb, N]
            in_node = node_of_doc == leaf[:, None]
            go_left = col <= b_s[:, None]
            new_assign = jnp.where(
                in_node, jnp.where(go_left, la[:, None], ra[:, None]),
                node_of_doc)
            node_of_doc = jnp.where(valid[:, None], new_assign, node_of_doc)

            def upd(arr, idx, val):
                return arr.at[cidx, idx].set(
                    jnp.where(valid, val, arr[cidx, idx]))

            if build_children:
                # right child directly, left by subtraction (parent − sibling)
                w_r = dw * (in_node & (~go_left) & valid[:, None])
                hist_r = hist_multi_xla(binned_T, grads, w_r, B)
                hist_l = hist[cidx, hidx[cidx, leaf]] - hist_r
                S_r = jnp.sum(w_r * grads, axis=1)
                SQ_r = jnp.sum(w_r * grads * grads, axis=1)
                C_r = jnp.sum(w_r, axis=1)
                S_l = pstats[:, 0] - S_r
                SQ_l = pstats[:, 1] - SQ_r
                C_l = pstats[:, 2] - C_r

                def dev(SQ, S, C):
                    return jnp.where(C > 0, SQ - S * S / jnp.maximum(C, 1.0),
                                     -jnp.inf)

                # ONE stacked scan over both children (mirrors grow_tree's
                # hist_lr batching — the scan is launch/dependency-bound,
                # so two sequential calls paid ~2× the chain per level)
                Cb_ = hist_l.shape[0]
                hist_lr = jnp.concatenate([hist_l, hist_r], axis=0)
                fm2 = (None if feature_masks is None
                       else jnp.concatenate([feature_masks, feature_masks],
                                            axis=0))
                g2, f2, b2, ok2 = best_splits(hist_lr, mls, fm2)
                g_l, f_l, b_l, ok_l = g2[:Cb_], f2[:Cb_], b2[:Cb_], ok2[:Cb_]
                g_r, f_r, b_r, ok_r = g2[Cb_:], f2[Cb_:], b2[Cb_:], ok2[Cb_:]

                # unconditional scalar-row writes (rows of invalid bags are
                # never mapped, so their contents are dead)
                hist = hist.at[:, 2 * k + 1].set(hist_l)
                hist = hist.at[:, 2 * k + 2].set(hist_r)
                hidx = upd(hidx, la, jnp.full((Cb,), 0, jnp.int32) + 2 * k + 1)
                hidx = upd(hidx, ra, jnp.full((Cb,), 0, jnp.int32) + 2 * k + 2)
                stats = stats.at[cidx, la].set(jnp.where(
                    valid[:, None], jnp.stack([S_l, SQ_l, C_l], axis=1),
                    stats[cidx, la]))
                stats = stats.at[cidx, ra].set(jnp.where(
                    valid[:, None], jnp.stack([S_r, SQ_r, C_r], axis=1),
                    stats[cidx, ra]))
                deviance = upd(upd(deviance, la, dev(SQ_l, S_l, C_l)),
                               ra, dev(SQ_r, S_r, C_r))
                best_gain = upd(upd(best_gain, la, g_l), ra, g_r)
                best_f = upd(upd(best_f, la, f_l), ra, f_r)
                best_b = upd(upd(best_b, la, b_l), ra, b_r)
                splittable = upd(upd(splittable, la, ok_l), ra, ok_r)

            feature = upd(feature, leaf, f_s)
            sbin = upd(sbin, leaf, b_s)
            left = upd(left, leaf, la)
            right = upd(right, leaf, ra)
            is_leaf = upd(is_leaf, leaf, jnp.zeros((Cb,), bool))
            is_leaf = upd(upd(is_leaf, la, jnp.ones((Cb,), bool)),
                          ra, jnp.ones((Cb,), bool))
            n_nodes = n_nodes + jnp.where(valid, jnp.int32(2), jnp.int32(0))

            return (hist, hidx, stats, deviance, best_gain, best_f, best_b,
                    splittable, feature, sbin, left, right, is_leaf,
                    node_of_doc, n_nodes, impacts)

        return body

    st = (hist, hidx, stats, deviance, best_gain, best_f, best_b, splittable,
          feature, sbin, left, right, is_leaf, node_of_doc, n_nodes, impacts)
    if n_leaves > 2:
        st = jax.lax.fori_loop(0, n_leaves - 2, make_body(True), st)
    st = make_body(False)(jnp.int32(n_leaves - 2), st)
    (hist, hidx, stats, deviance, best_gain, best_f, best_b, splittable,
     feature, sbin, left, right, is_leaf, node_of_doc, n_nodes, impacts) = st
    return TreeArrays(feature, sbin, left, right, is_leaf, n_nodes,
                      node_of_doc, impacts)


def leaf_outputs_forest(node_of_doc, lam, w, n_slots: int, newton: bool,
                        doc_weights=None):
    """Per-bag leaf outputs: leaf_outputs with a leading [Cb] axis, as one
    segment-sum over Cb·n_slots segments. lam/w: [Cb, N]."""
    Cb, N = node_of_doc.shape
    dw = None if doc_weights is None else doc_weights.astype(lam.dtype)
    if dw is not None:
        lam = lam * dw
    ids = (jnp.arange(Cb, dtype=jnp.int32)[:, None] * n_slots
           + node_of_doc).reshape(-1)
    s1 = jax.ops.segment_sum(lam.reshape(-1), ids,
                             num_segments=Cb * n_slots)
    if newton:
        ww = w if dw is None else w * dw
        s2 = jax.ops.segment_sum(ww.reshape(-1), ids,
                                 num_segments=Cb * n_slots)
    else:
        ones = jnp.ones_like(lam) if dw is None else dw
        s2 = jax.ops.segment_sum(ones.reshape(-1), ids,
                                 num_segments=Cb * n_slots)
    out = jnp.where(s2 > 0, s1 / jnp.where(s2 > 0, s2, 1.0), 0.0)
    return out.reshape(Cb, n_slots)


def leaf_outputs(node_of_doc, lam, w, n_slots: int, newton: bool,
                 doc_mask=None, axis_name: str | None = None):
    """Per-slot outputs: Newton step Σλ/Σw (LambdaMART,
    ref: LambdaMART.updateTreeOutput:~400) or mean response Σλ/count
    (MART, ref: learning/tree/MART.java:~15). ``doc_mask``: bool mask or
    f32 doc weights (multiplicities), like grow_tree.

    With only ``n_slots`` (= 2·nLeaves−1, ~19) segments, a masked [M, N]
    broadcast reduction does the work of M fused vector sums with no
    scatter contention, in exact f32 — leaf outputs feed model values,
    so no bf16 shortcut."""
    dw = None if doc_mask is None else doc_mask.astype(lam.dtype)
    if dw is not None:
        lam = lam * dw
    if newton:
        s2_src = w if dw is None else w * dw
    else:
        s2_src = jnp.ones_like(lam) if dw is None else dw
    onehot = (node_of_doc[None, :] ==
              jnp.arange(n_slots, dtype=node_of_doc.dtype)[:, None])
    s1 = jnp.sum(jnp.where(onehot, lam[None, :], 0.0), axis=1)
    s2 = jnp.sum(jnp.where(onehot, s2_src[None, :], 0.0), axis=1)
    if axis_name:
        s1 = jax.lax.psum(s1, axis_name)
        s2 = jax.lax.psum(s2, axis_name)
    return jnp.where(s2 > 0, s1 / jnp.where(s2 > 0, s2, 1.0), 0.0)
