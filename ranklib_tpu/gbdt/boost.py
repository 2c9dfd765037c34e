"""Fully-fused boosting rounds: one jitted, buffer-donated step per tree,
ZERO host synchronization inside the training loop.

Motivation: each blocking host↔device round trip stalls the device, so a
loop that syncs for the tree, the train metric, and the validation metric
pays in latency on top of compute. Here the whole round —
pseudo-responses → tree growth → Newton leaf outputs → score update →
train/validation metrics → on-device tree recording — is ONE XLA
program; metric histories and packed tree buffers accumulate on device
and the host reads everything back in a single transfer after the last
round.

The tree buffers are allocated at a power-of-two CAPACITY (≥128) rather
than at ``n_trees``, so the compiled step depends only on the data
shapes and the capacity class — an RF bag (1 tree) and a 100-tree run
share one executable, and the persistent compilation cache reuses it
across processes.

The reference's equivalent loop is LambdaMART.learn
(learning/tree/LambdaMART.java:~200); console logging still reproduces its
per-round table when not silent (at the documented latency cost).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ranklib_tpu.data.dataset import Dataset, bucketize, flatten_meta
from ranklib_tpu.gbdt.grow import grow_tree, leaf_outputs
from ranklib_tpu.gbdt.lambdas import (
    SEPARABLE_METRICS, chunk_scale, lambda_weights, lambda_weights_nosort,
    lambda_weights_nosort_err, lambda_weights_nosort_map,
)


def round_capacity(n_trees: int) -> int:
    cap = 128
    while cap < n_trees:
        cap *= 2
    return cap


class BoostData(NamedTuple):
    """Static-per-training device arrays (passed, not captured)."""

    binned_T: jnp.ndarray        # [F, Npad] int32
    labels_flat: jnp.ndarray     # [Npad] f32 (pads 0)
    doc_mask: jnp.ndarray        # [Npad] bool, or f32 doc weights (RF
                                 #   bags: with-replacement multiplicity)
    feat_mask: jnp.ndarray       # [F] bool (RF bags: feature subsample)
    tb: tuple                    # train buckets: ((labels, mask, didx), ...)
    vbinned: jnp.ndarray | None  # [Nvpad, F] int32 doc-major (traversal)
    vb: tuple                    # validation buckets (may be empty)
    tb_scale: tuple = ()         # per chunk [rows] f32: per-fit constant
                                 #   swap-delta scale for the sort-free
                                 #   lambda path (empty → sorted path)
    tb_inv: jnp.ndarray | None = None
    # [Npad] int32: position of each real doc in the concatenation of the
    # tb chunks' flattened [rows·D] layouts (pad docs → a guaranteed-zero
    # tail slot). Chunks PARTITION the docs, so the per-chunk
    # `lam.at[didx].add` scatters are one big permutation — and invert
    # into a single gather here.


class BoostState(NamedTuple):
    """Donated carry: scores + metric histories + packed tree buffers
    (leading dim = capacity class, NOT n_trees)."""

    scores: jnp.ndarray          # [Npad + 1] f32
    vscores: jnp.ndarray         # [Nvpad + 1] f32 (size 1 when no val)
    tfeat: jnp.ndarray           # [CAP, M] int32
    tbin: jnp.ndarray            # [CAP, M] int32
    tleft: jnp.ndarray           # [CAP, M] int32
    tright: jnp.ndarray          # [CAP, M] int32
    tleaf: jnp.ndarray           # [CAP, M] bool
    tout: jnp.ndarray            # [CAP, M] f32
    tnodes: jnp.ndarray          # [CAP] int32
    train_m: jnp.ndarray         # [CAP] f32
    val_m: jnp.ndarray           # [CAP] f32
    impacts: jnp.ndarray         # [F] f32 cumulative deviance reduction


def make_boost_data(train: Dataset, binned_pad: np.ndarray,
                    labels_pad: np.ndarray, n_real: int,
                    validation: Dataset | None,
                    vbinned: np.ndarray | None,
                    feature_mask: np.ndarray | None = None,
                    scorer=None) -> tuple:
    """Build (BoostData, Npad, Nvpad). ``binned_pad``: [Npad, F].
    ``scorer``: when given and product-separable, per-chunk swap-delta
    scales are precomputed once here (the sort-free lambda path)."""
    Npad, F = binned_pad.shape
    tb = _device_buckets(train, sentinel=n_real)
    vb = ()
    Nvpad = 0
    if validation is not None:
        vb = _device_buckets(validation, sentinel=vbinned.shape[0])
        Nvpad = vbinned.shape[0]
    tb_scale = ()
    if scorer is not None and scorer.metric in SEPARABLE_METRICS:
        tb_scale = tuple(chunk_scale(scorer, lab, msk)
                         for lab, msk, _ in tb)
    # inverse permutation of the chunk layout (see BoostData.tb_inv):
    # position of doc d inside concat(chunk didx.flatten()); pad docs and
    # chunk pad slots resolve to the zero tail slot appended by the step
    didx_flat = np.concatenate(
        [np.asarray(didx).reshape(-1) for _, _, didx in tb])
    inv = np.full(Npad + 1, len(didx_flat), np.int64)
    real = didx_flat < n_real
    inv[didx_flat[real]] = np.flatnonzero(real)
    return BoostData(
        binned_T=_upload_bins(np.ascontiguousarray(binned_pad.T)),
        labels_flat=jnp.asarray(labels_pad),
        doc_mask=jnp.asarray(np.arange(Npad) < n_real),
        feat_mask=jnp.asarray(np.ones(F, bool) if feature_mask is None
                              else feature_mask),
        tb=tb,
        vbinned=_upload_bins(vbinned) if vbinned is not None else None,
        vb=vb,
        tb_scale=tb_scale,
        tb_inv=jnp.asarray(inv[:Npad].astype(np.int32)),
    ), Npad, Nvpad


def _upload_bins(a: np.ndarray) -> jnp.ndarray:
    """Host→device transfer AND device residency of a bin matrix at
    int16 width. Bin ids are ≤ n_bins ≤ a few thousand; at MSLR-30K
    scale the int32 matrix was ~2 GB — narrowing it cuts both the setup
    transfer and the largest device array (raising the one-card doc
    ceiling). XLA consumers promote in fused elementwise ops."""
    mx = a.max(initial=0)
    if mx < 256:                 # B = 256 bins are 0..255 — one byte
        return jnp.asarray(a.astype(np.uint8))
    if mx < np.iinfo(np.int16).max:
        return jnp.asarray(a.astype(np.int16))
    return jnp.asarray(a)


# max elements of one [Bc, D, D] pair temporary (f32) — 2^24 ≈ 64 MB
_PAIR_BUDGET = 1 << 24


def _device_buckets(ds: Dataset, sentinel: int,
                    qidx_sentinel: int | None = None) -> tuple:
    """Padded (labels, mask, didx[, qidx]) chunks per bucket. Buckets are
    split into row chunks so no [Bc, D, D] pair temporary in the fused
    step exceeds the budget (the 'long-context' guard of SURVEY §5: pair
    matrices never pad to the global max doc count, and never blow HBM
    when a bucket holds thousands of queries).

    ``qidx_sentinel``: when given, each chunk additionally carries the
    per-row QUERY index (Dataset order; padding rows get the sentinel) —
    for scattering per-query metrics from flat scores (AdaRank's sparse
    route)."""
    _, qptr = flatten_meta(ds)
    out = []
    for b in bucketize(ds, with_feats=False):
        didx = np.full((b.B, b.D), sentinel, np.int32)
        for row, qi in enumerate(b.qidx):
            s, e = qptr[qi], qptr[qi + 1]
            didx[row, : e - s] = np.arange(s, e, dtype=np.int32)
        rows = max(1, min(b.B, _PAIR_BUDGET // (b.D * b.D)))
        for lo in range(0, b.B, rows):
            hi = min(lo + rows, b.B)
            pad = rows - (hi - lo)
            lab = np.pad(b.labels[lo:hi], ((0, pad), (0, 0)))
            msk = np.pad(b.mask[lo:hi], ((0, pad), (0, 0)))
            di = np.pad(didx[lo:hi], ((0, pad), (0, 0)),
                        constant_values=sentinel)
            chunk = (jnp.asarray(lab), jnp.asarray(msk), jnp.asarray(di))
            if qidx_sentinel is not None:
                qi_ = np.pad(b.qidx[lo:hi].astype(np.int32), (0, pad),
                             constant_values=qidx_sentinel)
                chunk += (jnp.asarray(qi_),)
            out.append(chunk)
    return tuple(out)


def _bucket_metric_sum(scorer, buckets, scores_flat, axis_name=None):
    total = jnp.float32(0.0)
    for lab, msk, didx in buckets:
        sc = scores_flat[didx]
        total += scorer.score_from_scores(lab, sc, msk).sum()
    if axis_name:
        total = jax.lax.psum(total, axis_name)
    return total


def make_round_step(scorer, *, n_bins: int, n_leaves: int,
                    min_leaf_support: int, learning_rate: float,
                    pointwise: bool, newton: bool, n_queries: int,
                    n_vqueries: int, train_metric: bool = True,
                    axis_name: str | None = None,
                    lambda_path: str = "auto"):
    """Build the jitted one-round step: (state, t, data) → state.

    ``train_metric=False`` skips the per-round train-metric evaluation —
    it exists only for the reference's console table (validation drives
    early stopping), so silent runs save its sort cost.

    ``axis_name``: set when the step runs per-device inside ``shard_map``
    (gbdt.boost_dist) — histograms, node statistics, and metric sums are
    then psum'd over that mesh axis.

    ``lambda_path``: "auto" (default routing below) or "sorted" (force
    the argsort reference path — A/B instrumentation).
    """
    M = 2 * n_leaves - 1
    lr = learning_rate
    # lambda path: sort-free (separable metrics need data.tb_scale;
    # ERR/MAP get prefix-matvec variants) > sorted XLA reference
    force_sorted = lambda_path == "sorted"
    use_nosort = not force_sorted and scorer.metric in SEPARABLE_METRICS
    lam_fn = lambda_weights
    if not force_sorted:
        if scorer.metric == "ERR":
            lam_fn = lambda_weights_nosort_err
        elif scorer.metric == "MAP":
            lam_fn = lambda_weights_nosort_map

    def step_impl(state: BoostState, t, data: BoostData) -> BoostState:
        scores = state.scores

        # ---- pseudo-responses ------------------------------------------
        if pointwise:
            lam = jnp.where(data.doc_mask > 0,
                            data.labels_flat - scores[:-1], 0.0)
            w = jnp.ones_like(lam)
        else:
            # per-doc bag multiplicity (weighted RF bags) is applied by
            # grow_tree/leaf_outputs via doc_mask weights, so lambdas stay
            # per-unique-doc here
            nosort = use_nosort and len(data.tb_scale) == len(data.tb)
            scales = data.tb_scale if nosort else (None,) * len(data.tb)
            parts_l, parts_w = [], []
            lam_f = w_f = None
            for (lab, msk, didx), scl in zip(data.tb, scales):
                if nosort:
                    l_, w_ = lambda_weights_nosort(scorer, lab,
                                                   scores[didx], msk, scl)
                else:
                    l_, w_ = lam_fn(scorer, lab, scores[didx], msk)
                if data.tb_inv is not None:
                    parts_l.append(l_.reshape(-1))
                    parts_w.append(w_.reshape(-1))
                else:
                    # distributed path (no inverse index yet): scatter-add
                    if lam_f is None:
                        lam_f = jnp.zeros_like(scores)
                        w_f = jnp.zeros_like(scores)
                    lam_f = lam_f.at[didx].add(jnp.where(msk, l_, 0.0))
                    w_f = w_f.at[didx].add(jnp.where(msk, w_, 0.0))
            if data.tb_inv is not None:
                # chunks PARTITION the docs, so gathering through the
                # precomputed inverse index replaces the per-chunk
                # scatter-adds. Chunk pad slots are never referenced; pad
                # docs hit the zero tail.
                zero = jnp.zeros((1,), scores.dtype)
                lam = jnp.concatenate(parts_l + [zero])[data.tb_inv]
                w = jnp.concatenate(parts_w + [zero])[data.tb_inv]
            else:
                lam, w = lam_f[:-1], w_f[:-1]
            # Force ONE materialization of the pair-phase outputs. grad is
            # read by every child histogram inside the growth loop, and at
            # MSLR-30K scale XLA chose to REMATERIALIZE the whole pairwise
            # computation at each read instead of keeping the [N] buffers:
            # measured 80 ms per histogram pass vs 28 ms in the pointwise
            # (MART) program whose grad is trivial — ~600 ms/round of
            # redundant recompute. The barrier makes lam/w opaque to the
            # scheduler.
            lam, w = jax.lax.optimization_barrier((lam, w))

        # ---- tree -------------------------------------------------------
        arr = grow_tree(data.binned_T, lam, n_bins=n_bins,
                        n_leaves=n_leaves,
                        min_leaf_support=min_leaf_support,
                        doc_mask=data.doc_mask, axis_name=axis_name,
                        feature_mask=data.feat_mask)
        out = leaf_outputs(arr.node_of_doc, lam, w, M, newton,
                           doc_mask=data.doc_mask, axis_name=axis_name)
        scores = scores.at[:-1].add(lr * out[arr.node_of_doc])

        # ---- train metric ----------------------------------------------
        train_m = state.train_m
        if train_metric:
            tm = _bucket_metric_sum(scorer, data.tb, scores,
                                    axis_name) / n_queries
            train_m = state.train_m.at[t].set(tm)

        # ---- validation -------------------------------------------------
        vscores = state.vscores
        val_m = state.val_m
        if data.vb:
            Nv = data.vbinned.shape[0]
            node = jnp.zeros((Nv,), jnp.int32)
            rows = jnp.arange(Nv)
            for _ in range(n_leaves):          # max depth of a leaf-wise tree
                vbin = data.vbinned[rows, arr.feature[node]]
                nxt = jnp.where(vbin <= arr.bin[node],
                                arr.left[node], arr.right[node])
                node = jnp.where(arr.is_leaf[node], node, nxt)
            vscores = vscores.at[:-1].add(lr * out[node])
            vm = _bucket_metric_sum(scorer, data.vb, vscores,
                                    axis_name) / n_vqueries
            val_m = state.val_m.at[t].set(vm)

        # ---- record tree on device -------------------------------------
        return BoostState(
            scores=scores, vscores=vscores,
            tfeat=state.tfeat.at[t].set(arr.feature),
            tbin=state.tbin.at[t].set(arr.bin),
            tleft=state.tleft.at[t].set(arr.left),
            tright=state.tright.at[t].set(arr.right),
            tleaf=state.tleaf.at[t].set(arr.is_leaf),
            tout=state.tout.at[t].set(out),
            tnodes=state.tnodes.at[t].set(arr.n_nodes),
            train_m=train_m, val_m=val_m,
            impacts=state.impacts + arr.impacts,
        )

    return _make_stepper(step_impl)


def _make_stepper(step_impl):
    """Wrap the raw round body into a callable stepper with two compiled
    entry points:

    * ``stepper(state, t, data)`` — one round per dispatch (used when the
      host needs per-round values: the reference's live console table).
    * ``stepper.multi(state, t0, t1, data)`` — rounds [t0, t1) chained in
      ONE dispatch via ``lax.fori_loop`` with *traced* bounds, so a single
      executable serves every chunk length. Each dispatch costs host
      latency; silent-mode training only needs host values at
      checkpoint/early-stop boundaries, so everything between them chains
      on device. Metric histories land in state.train_m/val_m exactly as
      with per-round stepping — semantics are bit-identical
      (tests/test_gbdt.py::test_multi_round_chunks_bit_identical).

    ``stepper.impl`` exposes the untraced body for shard_map wrappers
    (gbdt.boost_dist).
    """
    step = jax.jit(step_impl, donate_argnums=(0,))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def multi(state, t0, t1, *data):
        return jax.lax.fori_loop(
            t0, t1, lambda t, s: step_impl(s, t, *data), state)

    def stepper(state, t, *data):
        return step(state, t, *data)

    stepper.multi = multi
    stepper.impl = step_impl
    return stepper


def run_silent_blocks(step, state, n_rounds: int, *data, block: int = 50):
    """Silent-mode round driver shared by RankBoost and AdaRank: chain
    ``block`` rounds per dispatch (step.multi) with ONE host sync between
    blocks — the on-device ``active`` flag check that stops dispatching
    no-op rounds. Bit-identical to per-round stepping. Chaining removes
    the one cost that scales with rounds × dispatch latency."""
    t = 0
    while t < n_rounds:
        t1 = min(t + block, n_rounds)
        state = step.multi(state, t, t1, *data)
        t = t1
        if not bool(state.active):
            break
    return state


def init_state(n_trees: int, n_leaves: int, Npad: int, Nvpad: int,
               n_features: int) -> BoostState:
    M = 2 * n_leaves - 1
    CAP = round_capacity(n_trees)
    return BoostState(
        impacts=jnp.zeros((n_features,), jnp.float32),
        scores=jnp.zeros((Npad + 1,), jnp.float32),
        vscores=jnp.zeros((Nvpad + 1,), jnp.float32),
        tfeat=jnp.zeros((CAP, M), jnp.int32),
        tbin=jnp.zeros((CAP, M), jnp.int32),
        tleft=jnp.full((CAP, M), -1, jnp.int32),
        tright=jnp.full((CAP, M), -1, jnp.int32),
        tleaf=jnp.zeros((CAP, M), bool),
        tout=jnp.zeros((CAP, M), jnp.float32),
        tnodes=jnp.zeros((CAP,), jnp.int32),
        train_m=jnp.full((CAP,), jnp.nan, jnp.float32),
        val_m=jnp.full((CAP,), jnp.nan, jnp.float32),
    )
