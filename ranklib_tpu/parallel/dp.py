"""Data-parallel machinery for the NON-tree rankers.

The GBDT family shards queries over a 1-D ``"batch"`` mesh in
``gbdt/boost_dist.py``; this module extends the same design to the other
training loops, whose per-round statistics are all query-local sums
(SURVEY §2 owed-rows; the reference's analog is one thread pool
partitioning query ranges, utilities/MyThreadPool.java:~10):

* RankBoost — the pair-potential normalizer Z, the weak-search histogram
  ``[F, T+1]`` and the metric sums all-reduce with ``psum``; everything
  else (argmax, α, the weak-ranker record) replicates deterministically.
* AdaRank — the weighted weak-metric vector P·S, the α numerator/
  denominator, the reweighting normalizer Σe^{−metric} and the metric
  sums are psum'd; the per-query weights P stay sharded.
* Neural rankers — queries are dealt round-robin per size class and each
  device steps its LOCAL query in lockstep; per-step gradients psum over
  the mesh, so ``-dp n`` trains a synchronous minibatch of n queries per
  step (the documented departure from the reference's strictly
  sequential per-query SGD — identical at n=1, standard synchronous
  data-parallel SGD otherwise).

Shared here: a round-robin per-size-class sharder producing stacked
per-device feature buckets (host peak = the stacked dense buckets, same
as the single-device bucketize), and a spec-driven ``shard_map`` stepper
factory that wraps any fused round body (single + chained-multi entry
points, mirroring ``gbdt.boost._make_stepper``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ranklib_tpu.data.dataset import Dataset, query_feats
from ranklib_tpu.gbdt.boost_dist import AXIS, _place, _shard_queries

__all__ = ["AXIS", "shard_feat_buckets", "shard_sparse_data",
           "make_dist_stepper", "place_sharded", "place_replicated"]


def place_sharded(a, mesh: Mesh):
    return _place(a, mesh, sharded=True)


def place_replicated(a, mesh: Mesh):
    return _place(a, mesh, sharded=False)


def shard_feat_buckets(ds: Dataset, n_dev: int, mesh: Mesh,
                       want_qidx: bool = False, doc_budget: int | None = None):
    """Stacked per-device feature buckets.

    Queries are dealt round-robin per padded-size class (the same layout
    rule as ``gbdt.boost_dist._shard_arrays``), so every device holds
    IDENTICAL chunk shapes — shard_map's single-program requirement.

    Returns ``(chunks, Qpad, per_dev)`` — ``per_dev`` is the per-device
    ``[(D, qi), ...]`` query assignment (``gbdt.boost_dist._shard_queries``
    order), defining each query's local slot. chunks is a tuple of
    ``(feats [n_dev, rows, D, F], labels [n_dev, rows, D],
    mask [n_dev, rows, D][, qidx [n_dev, rows]])`` device arrays sharded
    on the leading axis; padded rows carry all-False masks. ``qidx`` is
    the query's LOCAL slot on its device (padding rows get the sentinel
    ``Qpad`` = the uniform per-device slot count); per-query quantities
    indexed by it live in ``[Qpad + 1]`` arrays whose last slot is the
    padding accumulator.

    ``doc_budget``: optional max padded docs per chunk (rows·D) — the
    [rows, D, C] guard of ops.batched_eval.
    """
    per_dev, class_rows = _shard_queries(ds, n_dev)
    F = ds.n_features
    Qpad = max((len(lst) for lst in per_dev), default=0)
    chunks = []
    for D in sorted(class_rows):
        rows = class_rows[D]
        feats = np.zeros((n_dev, rows, D, F), np.float32)
        labels = np.zeros((n_dev, rows, D), np.float32)
        mask = np.zeros((n_dev, rows, D), bool)
        qidx = np.full((n_dev, rows), Qpad, np.int32)
        for dev, lst in enumerate(per_dev):
            r = 0
            # local slot of a query = its position in the device's full
            # (class-sorted) list — per-query arrays use this numbering
            for j, (Dq, qi) in enumerate(lst):
                if Dq != D:
                    continue
                q = ds.queries[qi]
                feats[dev, r, : q.n] = query_feats(ds, qi)
                labels[dev, r, : q.n] = q.labels
                mask[dev, r, : q.n] = True
                qidx[dev, r] = j
                r += 1
        chunk_rows = rows
        if doc_budget is not None:
            chunk_rows = max(1, min(rows, doc_budget // D))
        for lo in range(0, rows, chunk_rows):
            hi = min(lo + chunk_rows, rows)
            pad = chunk_rows - (hi - lo)

            def cut(a, cv):
                return place_sharded(
                    np.pad(a[:, lo:hi],
                           ((0, 0), (0, pad)) + ((0, 0),) * (a.ndim - 2),
                           constant_values=cv), mesh)

            c = (cut(feats, 0), cut(labels, 0), cut(mask, False))
            if want_qidx:
                c += (cut(qidx, Qpad),)
            chunks.append(c)
    return tuple(chunks), Qpad, per_dev


def shard_sparse_data(ds, n_dev: int, mesh: Mesh, want_qidx: bool = True):
    """Stacked per-device SPARSE evaluation data — the ``-sparse -dp``
    cross product (AdaRank once silently dropped -dp on wide CSR
    data).

    Per-device analog of ``ops.sparse_eval.build_sparse_data``: queries
    are dealt round-robin per padded-size class (``_shard_queries`` — the
    shard_map single-program layout), each device's docs are laid out
    flat in its list order, and the COO triple + metric buckets are
    padded to IDENTICAL shapes across devices and sharded on the leading
    axis.

    Returns ``(chunks, buckets, Qpad, Npad, per_dev)``:

    * chunks — tuple of (fids [n_dev, C] i32, vals [n_dev, C] f32,
      rowid [n_dev, C] i32); padding entries point at the sentinel row
      ``Npad`` (each device's flat score table is [Npad + 1]).
    * buckets — per size class (labels [n_dev, rows, D] f32,
      mask [n_dev, rows, D] bool, didx [n_dev, rows, D] i32 into the
      device-LOCAL doc space[, qidx [n_dev, rows] i32 local query slot —
      only when ``want_qidx``, so callers whose metric sums never index
      per-query slots skip one sharded upload per size class];
      sentinels Npad / Qpad).
    * Qpad — uniform per-device query-slot count; Npad — uniform
      per-device padded doc count.
    * per_dev — the ``_shard_queries`` dealing this layout was built
      from; callers aligning per-query side arrays (AdaRank's S matrix)
      MUST consume this instead of re-deriving it (review finding,
      round 5: a second independent ``_shard_queries`` call must stay
      deal-for-deal identical or S rows silently misalign).

    Works for CSRDataset (materialize_query — lazy norm/clip/last-wins
    exact) and for a dense Dataset (query_feats), so a dense validation
    file next to CSR train shards the same way.
    """
    from ranklib_tpu.ops.sparse_eval import coo_chunk_size

    per_dev, class_rows = _shard_queries(ds, n_dev)
    Qpad = max((len(lst) for lst in per_dev), default=0)
    Npad = max((sum(ds.queries[qi].n for _, qi in lst)
                for lst in per_dev), default=1) or 1

    csr = hasattr(ds, "materialize_query")
    coo = []                        # per device (fids, vals, rowid)
    # per class: labels/mask/didx[/qidx] arrays
    buckets = {D: (np.zeros((n_dev, rows, D), np.float32),
                   np.zeros((n_dev, rows, D), bool),
                   np.full((n_dev, rows, D), Npad, np.int32))
               + ((np.full((n_dev, rows), Qpad, np.int32),)
                  if want_qidx else ())
               for D, rows in class_rows.items()}
    row_ptr = {D: [0] * n_dev for D in class_rows}
    for dev, lst in enumerate(per_dev):
        f_parts, v_parts, r_parts = [], [], []
        doc0 = 0
        for j, (D, qi) in enumerate(lst):
            q = ds.queries[qi]
            X = (ds.materialize_query(qi) if csr
                 else query_feats(ds, qi))
            r, f = np.nonzero(X)
            f_parts.append(f.astype(np.int32))
            v_parts.append(np.asarray(X, np.float32)[r, f])
            r_parts.append((r + doc0).astype(np.int32))
            labels, mask, didx = buckets[D][:3]
            row = row_ptr[D][dev]
            labels[dev, row, : q.n] = q.labels
            mask[dev, row, : q.n] = True
            didx[dev, row, : q.n] = np.arange(doc0, doc0 + q.n)
            if want_qidx:
                buckets[D][3][dev, row] = j
            row_ptr[D][dev] = row + 1
            doc0 += q.n
        coo.append((np.concatenate(f_parts) if f_parts
                    else np.zeros(0, np.int32),
                    np.concatenate(v_parts) if v_parts
                    else np.zeros(0, np.float32),
                    np.concatenate(r_parts) if r_parts
                    else np.zeros(0, np.int32)))

    nnz_max = max(len(f) for f, _, _ in coo)
    chunk = coo_chunk_size(nnz_max)
    C_total = max(1, -(-nnz_max // chunk)) * chunk
    fids = np.zeros((n_dev, C_total), np.int32)
    vals = np.zeros((n_dev, C_total), np.float32)
    rowid = np.full((n_dev, C_total), Npad, np.int32)   # sentinel pad
    for dev, (f, v, r) in enumerate(coo):
        fids[dev, : len(f)] = f
        vals[dev, : len(v)] = v
        rowid[dev, : len(r)] = r
    chunks = tuple(
        (place_sharded(fids[:, s: s + chunk], mesh),
         place_sharded(vals[:, s: s + chunk], mesh),
         place_sharded(rowid[:, s: s + chunk], mesh))
        for s in range(0, C_total, chunk))
    bks = tuple(
        tuple(place_sharded(a, mesh) for a in buckets[D])
        for D in sorted(buckets))
    return chunks, bks, Qpad, Npad, per_dev


def _tree_sq(tree, specs, sh):
    return jax.tree.map(lambda x, sp: x[0] if sp == sh else x, tree, specs)


def _tree_ex(tree, specs, sh):
    return jax.tree.map(lambda x, sp: x[None] if sp == sh else x, tree,
                        specs)


def make_dist_stepper(step_impl, mesh: Mesh, state_specs, data_specs,
                      axis: str = AXIS):
    """shard_map a fused round body over the mesh.

    ``step_impl(state, t, *data) -> state`` is the per-device body (built
    with ``axis_name=axis`` so its global reductions psum). ``state_specs``
    / ``data_specs`` are pytrees of PartitionSpec matching state / each
    data arg: ``P(axis)`` leaves carry a stacked leading device axis
    (squeezed per device), ``P()`` leaves are replicated. Returns a
    stepper with the ``(state, t, *data)`` / ``.multi(state, t0, t1,
    *data)`` contract of ``gbdt.boost._make_stepper`` (so
    ``run_silent_blocks`` drives it unchanged).
    """
    sh = P(axis)
    rep = P()

    def per_device(state, t, *data):
        st = _tree_sq(state, state_specs, sh)
        dt = tuple(_tree_sq(d, ds_, sh) for d, ds_ in zip(data, data_specs))
        out = step_impl(st, t, *dt)
        return _tree_ex(out, state_specs, sh)

    mapped = jax.shard_map(per_device, mesh=mesh,
                           in_specs=(state_specs, rep, *data_specs),
                           out_specs=state_specs, check_vma=False)

    def per_device_multi(state, t0, t1, *data):
        return jax.lax.fori_loop(
            t0, t1, lambda t, s: per_device(s, t, *data), state)

    mapped_multi = jax.shard_map(per_device_multi, mesh=mesh,
                                 in_specs=(state_specs, rep, rep,
                                           *data_specs),
                                 out_specs=state_specs, check_vma=False)

    def stepper(state, t, *data):
        return stepper._single(state, t, *data)

    stepper._single = jax.jit(mapped, donate_argnums=(0,))
    stepper.multi = jax.jit(mapped_multi, donate_argnums=(0,))
    return stepper
