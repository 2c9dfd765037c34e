"""Data-parallel fused boosting over a ``jax.sharding.Mesh``.

Queries shard across a 1-D ``"batch"`` mesh axis; each device runs the
SAME fused round (gbdt.boost.make_round_step) on its local shard with
``axis_name`` set, so per-tree histograms and node statistics all-reduce
with ``psum`` over the card links and every device takes identical
split decisions (SURVEY.md §2 equivalents table, §5 communication row —
histograms are F × bins × 2 floats ≈ 280 KB, which is why GBDT
data-parallel scales). The lambda phase needs no communication at all:
every pair matrix is query-local.

Layout: per size-class, queries are dealt round-robin to devices and each
device's row count is padded to the class maximum, so every shard has
IDENTICAL bucket-chunk shapes — a requirement of ``shard_map``'s
single-program model. Per-device flat doc arrays are padded to a common
``Npad``. Multi-host: run ``jax.distributed.initialize()`` first; the
same program then spans hosts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ranklib_tpu.data.dataset import Dataset, padded_size
from ranklib_tpu.gbdt.boost import (
    BoostData, BoostState, _PAIR_BUDGET, make_round_step, round_capacity,
)

AXIS = "batch"


def _place(a, mesh: Mesh, sharded: bool, axis: str = AXIS):
    """Device-put a host array onto the mesh: leading-axis sharded or
    replicated. Multi-process aware: under ``jax.distributed`` each
    process contributes only its local shard via
    ``make_array_from_process_local_data`` (device_put cannot address
    remote devices)."""
    spec = P(axis) if sharded else P()
    sh = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(a), sh)
    a = np.asarray(a)
    if sharded:
        per = a.shape[0] // jax.process_count()
        lo = jax.process_index() * per
        a = np.ascontiguousarray(a[lo: lo + per])
    return jax.make_array_from_process_local_data(sh, a)


def _shard_queries(ds: Dataset, n_dev: int):
    """Round-robin per size-class → per-device query-index lists plus the
    uniform per-class row count."""
    classes = {}
    for qi, q in enumerate(ds.queries):
        classes.setdefault(padded_size(q.n), []).append(qi)
    per_dev = [[] for _ in range(n_dev)]        # [(D, qi), ...] per device
    class_rows = {}
    for D in sorted(classes):
        idxs = classes[D]
        rows = -(-len(idxs) // n_dev)           # ceil
        class_rows[D] = rows
        for j, qi in enumerate(idxs):
            per_dev[j % n_dev].append((D, qi))
    return per_dev, class_rows


def _shard_arrays(ds: Dataset, binned: np.ndarray, n_dev: int,
                  bin_dtype=np.int32):
    """Per-device padded flat arrays + uniform bucket chunks for one
    dataset. Returns (binned_T [n_dev,F,Npad], labels_flat, doc_mask,
    chunks tuple, Npad). ``bin_dtype``: host/transfer dtype of the bin
    matrix — int16 (when the bin range allows) halves the host copy and
    the link bytes; callers upcast ON DEVICE."""
    from ranklib_tpu.data.dataset import flatten_meta
    from ranklib_tpu.models.gbdt import _pad_doc_count

    _, qptr = flatten_meta(ds)
    F = binned.shape[1]
    per_dev, class_rows = _shard_queries(ds, n_dev)

    Npad = _pad_doc_count(max(
        sum(ds.queries[qi].n for _, qi in dev) for dev in per_dev) or 1)

    binned_T = np.zeros((n_dev, F, Npad), bin_dtype)
    labels_flat = np.zeros((n_dev, Npad), np.float32)
    doc_mask = np.zeros((n_dev, Npad), bool)
    # per class: labels/mask/didx [n_dev, rows, D]
    buckets = {D: (np.zeros((n_dev, rows, D), np.float32),
                   np.zeros((n_dev, rows, D), bool),
                   np.full((n_dev, rows, D), Npad, np.int32))
               for D, rows in class_rows.items()}
    row_ptr = {}

    for dev, lst in enumerate(per_dev):
        pos = 0
        for D, qi in lst:
            q = ds.queries[qi]
            s = qptr[qi]
            binned_T[dev, :, pos: pos + q.n] = binned[s: s + q.n].T
            labels_flat[dev, pos: pos + q.n] = q.labels
            doc_mask[dev, pos: pos + q.n] = True
            lab, msk, didx = buckets[D]
            r = row_ptr.get((dev, D), 0)
            row_ptr[(dev, D)] = r + 1
            lab[dev, r, : q.n] = q.labels
            msk[dev, r, : q.n] = True
            didx[dev, r, : q.n] = np.arange(pos, pos + q.n, dtype=np.int32)
            pos += q.n

    chunks = []
    for D in sorted(buckets):
        lab, msk, didx = buckets[D]
        rows = lab.shape[1]
        chunk = max(1, min(rows, _PAIR_BUDGET // (D * D)))
        for lo in range(0, rows, chunk):
            hi = min(lo + chunk, rows)
            pad = chunk - (hi - lo)
            chunks.append(tuple(
                jnp.asarray(np.pad(a[:, lo:hi], ((0, 0), (0, pad), (0, 0)),
                                   constant_values=cv))
                for a, cv in ((lab, 0), (msk, False), (didx, Npad))))
    return binned_T, labels_flat, doc_mask, tuple(chunks), Npad


def scatter_doc_values(ds: Dataset, values: np.ndarray, n_dev: int,
                       Npad: int) -> np.ndarray:
    """Scatter per-doc values (flatten order, [N]) into the per-device
    flat doc layout used by :func:`_shard_arrays` → [n_dev, Npad + 1]
    (the trailing slot is the padding accumulator, left 0). Used to seed
    warm-start model scores in the distributed path."""
    qptr = np.zeros(len(ds.queries) + 1, np.int64)
    np.cumsum([q.n for q in ds.queries], out=qptr[1:])
    per_dev, _ = _shard_queries(ds, n_dev)
    out = np.zeros((n_dev, Npad + 1), np.float32)
    for dev, lst in enumerate(per_dev):
        pos = 0
        for _, qi in lst:
            n = ds.queries[qi].n
            out[dev, pos: pos + n] = values[qptr[qi]: qptr[qi] + n]
            pos += n
    return out


def build_sharded_data(train: Dataset, binned: np.ndarray, n_dev: int,
                       validation: Dataset | None = None,
                       vbinned: np.ndarray | None = None,
                       feature_mask: np.ndarray | None = None,
                       mesh: Mesh | None = None, scorer=None):
    """Stacked per-device BoostData (leading device axis on every leaf).

    ``binned`` / ``vbinned``: [N, F] int32 for the REAL docs (flatten
    order). Returns (data, Npad, Nvpad); every device's flat doc axes pad
    to the common Npad / Nvpad.
    """
    # narrow host/transfer/device discipline (XLA consumers promote in
    # fused ops — see gbdt.boost._upload_bins).
    # The dtype must cover the VALIDATION bins too: validation values
    # above a feature's train max bin to n_bins (256 at default -tc),
    # and a train-only max of 255 picked uint8 — the numpy shard fill
    # then WRAPPED 256→0, silently left-routing those docs in every -dp
    # validation traversal (review finding: the narrow-bin footgun).
    mx = np.asarray(binned).max(initial=0)
    if vbinned is not None:
        mx = max(mx, np.asarray(vbinned).max(initial=0))
    bdt = (np.uint8 if mx < 256
           else np.int16 if mx < np.iinfo(np.int16).max else np.int32)
    binned_T, labels_flat, doc_mask, tb, Npad = _shard_arrays(
        train, binned, n_dev, bin_dtype=bdt)
    vb = ()
    vbin_dev = None
    Nvpad = 0
    if validation is not None:
        vbinned_T, _, _, vb, Nvpad = _shard_arrays(validation, vbinned,
                                                   n_dev, bin_dtype=bdt)
        # traversal wants doc-major [Nvpad, F] per device
        vbin_dev = np.ascontiguousarray(vbinned_T.transpose(0, 2, 1))
    F = binned.shape[1]
    fm = np.ones(F, bool) if feature_mask is None else feature_mask
    if mesh is None:
        put = jnp.asarray
    else:
        put = lambda a: _place(a, mesh, sharded=True)
    tb_scale = ()
    if scorer is not None:
        from ranklib_tpu.gbdt.lambdas import SEPARABLE_METRICS, chunk_scale

        if scorer.metric in SEPARABLE_METRICS:
            # per-fit swap-delta scales, stacked on the device axis
            # like the chunks they belong to (sort-free lambda path)
            tb_scale = tuple(
                put(np.asarray(
                    chunk_scale(scorer, jnp.asarray(lab).reshape(-1, lab.shape[-1]),
                                jnp.asarray(msk).reshape(-1, msk.shape[-1]))
                ).reshape(lab.shape[0], lab.shape[1]))
                for lab, msk, _ in tb)
    data = BoostData(
        binned_T=put(np.asarray(binned_T)),
        labels_flat=put(labels_flat),
        doc_mask=put(doc_mask),
        feat_mask=put(np.tile(fm, (n_dev, 1))),
        tb=jax.tree.map(lambda a: put(np.asarray(a)), tb),
        vbinned=put(vbin_dev) if vbin_dev is not None else None,
        vb=jax.tree.map(lambda a: put(np.asarray(a)), vb),
        tb_scale=tb_scale,
    )
    return data, Npad, Nvpad


def make_dist_round_step(scorer, mesh: Mesh, data: BoostData, *, n_bins,
                         n_leaves, min_leaf_support, learning_rate,
                         pointwise, newton, n_queries, n_vqueries=1,
                         train_metric=True, axis: str = AXIS):
    """shard_map'd fused round: (stacked state, t, stacked data) → state.

    State layout: scores/vscores sharded on the leading device axis;
    metric histories and tree buffers replicated (identical on every
    device because all statistics are psum'd). ``data`` (the stacked
    BoostData) is needed here only to derive its PartitionSpec pytree.
    """
    from ranklib_tpu.parallel.dp import make_dist_stepper

    step = make_round_step(
        scorer, n_bins=n_bins, n_leaves=n_leaves,
        min_leaf_support=min_leaf_support, learning_rate=learning_rate,
        pointwise=pointwise, newton=newton, n_queries=n_queries,
        n_vqueries=n_vqueries, train_metric=train_metric, axis_name=axis).impl

    sh = P(axis)
    rep = P()
    state_specs = BoostState(scores=sh, vscores=sh, tfeat=rep, tbin=rep,
                             tleft=rep, tright=rep, tleaf=rep, tout=rep,
                             tnodes=rep, train_m=rep, val_m=rep, impacts=rep)
    data_specs = jax.tree.map(lambda _: sh, data)
    # the generic spec-driven shard_map stepper (parallel/dp.py) owns the
    # per-device squeeze/expand, the in-shard_map fori chaining and the
    # donated jit entries — one copy of the distributed plumbing for the
    # GBDT family AND the non-tree rankers
    return make_dist_stepper(step, mesh, state_specs, (data_specs,),
                             axis=axis)


def init_dist_state(n_trees: int, n_leaves: int, n_dev: int, Npad: int,
                    mesh: Mesh, Nvpad: int = 0, n_features: int = 1,
                    axis: str = AXIS) -> BoostState:
    M = 2 * n_leaves - 1
    CAP = round_capacity(n_trees)
    shd = lambda a: _place(a, mesh, sharded=True, axis=axis)
    rep = lambda a: _place(a, mesh, sharded=False, axis=axis)
    return BoostState(
        impacts=rep(np.zeros((n_features,), np.float32)),
        scores=shd(np.zeros((n_dev, Npad + 1), np.float32)),
        vscores=shd(np.zeros((n_dev, Nvpad + 1), np.float32)),
        tfeat=rep(np.zeros((CAP, M), np.int32)),
        tbin=rep(np.zeros((CAP, M), np.int32)),
        tleft=rep(np.full((CAP, M), -1, np.int32)),
        tright=rep(np.full((CAP, M), -1, np.int32)),
        tleaf=rep(np.zeros((CAP, M), bool)),
        tout=rep(np.zeros((CAP, M), np.float32)),
        tnodes=rep(np.zeros((CAP,), np.int32)),
        train_m=rep(np.full((CAP,), np.nan, np.float32)),
        val_m=rep(np.full((CAP,), np.nan, np.float32)),
    )
