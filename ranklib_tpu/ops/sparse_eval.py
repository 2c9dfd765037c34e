"""Device-resident sparse candidate evaluation (embedding-style layer).

The dense candidate evaluator (ops.batched_eval) holds every padded
``[rows, D, F]`` feature block in HBM — the right call for MSLR-class
widths, but the DEVICE-memory wall for wide sparse data (data/sparse.py
module note; the reference's storage answer is
learning/SparseDataPoint.java:~15). This module keeps the dataset on
device in COO form instead — ``fids``/``vals``/``rowid``, memory ~
nonzeros — and evaluates candidate weight matrices with the
embedding-style primitive:

    scores[n, k] = Σ_{j : rowid[j]=n} vals[j] · W[fids[j], k]

i.e. a gather of W rows by fid (one [chunk, K] embedding lookup) followed
by a SORTED segment-sum back to doc rows. The nnz axis is processed in
fixed-size chunks so the gather temporary is bounded (~128 MB at
K = 256); rows may span chunk boundaries — per-chunk partial segment
sums add into the flat score table, exact because row-slot addition
commutes with chunking.

The COO is extracted from MATERIALIZED bounded chunks
(CSRDataset.materialize_rows — the pipeline's ground truth), so lazy
normalization, fid clipping and duplicate-fid last-wins semantics are
inherited exactly rather than re-implemented. Note zscore/linear
normalization DENSIFIES per query (implicit zeros map to −μ/σ ≠ 0): the
COO then holds ~docs × per-query-present-features entries — still far
below N·F for sparse data, but not ~file-nnz; ``sum`` keeps zeros at
zero.

The caller routes to this path only when the dense blocks would not
fit the device-memory budget below.
Numerically the result can differ from the dense matmul in the last
ulps (f32 reduction over a row's nonzeros vs all F columns), so parity
tests pin tight tolerances, not byte equality.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ranklib_tpu.metrics.base import MetricScorer

# nnz entries per device chunk: bounds the [CHUNK, K] gather temporary
# (128 MB f32 at K = 256)
NNZ_CHUNK = 1 << 17


def _default_dense_budget() -> int:
    """1/16 of the first device's memory limit (``memory_stats`` →
    ``bytes_limit``); 1 GB where the backend reports no limit (CPU)."""
    stats = jax.devices()[0].memory_stats() or {}    # None on the CPU
    limit = int(stats.get("bytes_limit", 0))
    return limit // 16 if limit > 0 else 1 << 30


def device_dense_budget_bytes() -> int:
    """Device-memory budget for dense bucket residency (env
    RANKLIB_TPU_DEVICE_DENSE_MB; default 1/16 of the device's memory
    limit). Above it, rankers that support this module route candidate
    evaluation through the sparse layer instead of uploading dense
    blocks."""
    import os

    mb = os.environ.get("RANKLIB_TPU_DEVICE_DENSE_MB")
    if mb is None:
        return _default_dense_budget()
    try:
        return max(0, int(mb)) << 20      # 0 forces the sparse layer
    except ValueError:
        return _default_dense_budget()


def wants_sparse_eval(ds) -> bool:
    """True when ``ds`` is a CSRDataset whose dense device blocks would
    exceed the budget — the routing predicate for the sparse layer."""
    return (bool(ds.queries) and ds.queries[0].feats is None
            and hasattr(ds, "materialize_rows")
            and ds.n_docs * ds.n_features * 4 > device_dense_budget_bytes())


def coo_chunk_size(nnz_max: int) -> int:
    """COO gather-chunk sizing policy, shared by the single-device layer
    and the -dp sharder (parallel/dp.py) so the two cannot drift: next
    power of two covering nnz, capped at NNZ_CHUNK — small datasets must
    not pay a full 131K-entry gather of padding per call."""
    chunk = 1 << 12
    while chunk < nnz_max and chunk < NNZ_CHUNK:
        chunk <<= 1
    return chunk


def build_sparse_data(ds):
    """Device pytree for the jitted evaluation core.

    ``ds``: a data.sparse.CSRDataset. Returns (chunks, buckets, N) where
    chunks is a tuple of (fids [C] i32, vals [C] f32, rowid [C] i32)
    with padding entries pointing at the sentinel row N, and buckets are
    the (labels, mask, didx) metric buckets of
    gbdt.boost._device_buckets.
    """
    from ranklib_tpu.data.sparse import _chunk_bytes
    from ranklib_tpu.gbdt.boost import _device_buckets

    N, F = ds.n_docs, ds.n_features
    rows_per = max(1, _chunk_bytes() // (F * 4))
    if not hasattr(ds, "materialize_rows"):
        # dense Dataset (e.g. a narrow validation file next to a wide
        # CSR train): slice the per-query feature blocks directly —
        # flatten(ds) copied the ENTIRE [N, F] into a closure held for
        # the whole extraction, doubling host memory exactly in the
        # regime this layer exists for (review finding, round 5)
        qstart = np.zeros(len(ds.queries) + 1, np.int64)
        np.cumsum([q.n for q in ds.queries], out=qstart[1:])

        def materialize(lo, hi):
            out = np.zeros((hi - lo, F), np.float32)
            qi = int(np.searchsorted(qstart, lo, side="right") - 1)
            while qi < len(ds.queries) and qstart[qi] < hi:
                r0 = int(max(qstart[qi], lo))
                r1 = int(min(qstart[qi + 1], hi))
                q = ds.queries[qi]
                w = min(q.feats.shape[1], F)
                out[r0 - lo: r1 - lo, :w] = (
                    q.feats[r0 - qstart[qi]: r1 - qstart[qi], :w])
                qi += 1
            return out
    else:
        materialize = ds.materialize_rows
    f_parts, v_parts, r_parts = [], [], []
    for lo in range(0, N, rows_per):
        hi = min(lo + rows_per, N)
        X = materialize(lo, hi)               # norm/clip/last-wins exact
        r, f = np.nonzero(X)
        f_parts.append(f.astype(np.int32))
        v_parts.append(X[r, f].astype(np.float32))
        r_parts.append((r + lo).astype(np.int32))
    fids = (np.concatenate(f_parts) if f_parts else np.zeros(0, np.int32))
    vals = (np.concatenate(v_parts) if v_parts else np.zeros(0, np.float32))
    rowid = (np.concatenate(r_parts) if r_parts else np.zeros(0, np.int32))
    chunk = coo_chunk_size(len(fids))
    pad = (-len(fids)) % chunk
    if pad:
        fids = np.pad(fids, (0, pad))
        vals = np.pad(vals, (0, pad))
        rowid = np.pad(rowid, (0, pad), constant_values=N)  # sentinel row
    chunks = tuple(
        (jnp.asarray(fids[s: s + chunk]),
         jnp.asarray(vals[s: s + chunk]),
         jnp.asarray(rowid[s: s + chunk]))
        for s in range(0, len(fids), chunk))
    buckets = _device_buckets(ds, sentinel=N)
    return chunks, buckets, N


def sparse_scores_flat(Wf, chunks, N):
    """Wf [F, K] → flat scores [N + 1, K] (sentinel row last) via chunked
    gather + sorted segment-sum."""
    K = Wf.shape[1]
    S = jnp.zeros((N + 1, K), jnp.float32)
    for fids, vals, rowid in chunks:
        part = Wf[fids] * vals[:, None]                       # [C, K]
        S = S + jax.ops.segment_sum(part, rowid, num_segments=N + 1,
                                    indices_are_sorted=True)
    return S


def adarank_weak_matrix(ds, scorer: MetricScorer) -> np.ndarray:
    """AdaRank's weak-metric matrix S[q, f] = metric of query q ranked by
    feature f alone — built SPARSELY: a feature absent from a query
    produces all-equal (zero) scores, whose stable ranking is the
    original order, so S[q, f] defaults to the query's zero-score metric
    m0(q); only the PRESENT (query, feature) pairs are evaluated,
    batched per padded-size class with a per-class candidate pad. Avoids
    the dense evaluator's ``feats @ eye(F)`` (an [N, F] residency +
    [F, F] candidate matrix — impossible at 50K+ features).

    Returns the dense [Q, F] f32 matrix — at wide F this is the
    remaining AdaRank ceiling (Q·F, e.g. 500 × 100K = 200 MB), far below
    the N·F the dense evaluator needs.
    """
    import jax

    from ranklib_tpu.data.dataset import padded_size

    Q, F = len(ds.queries), ds.n_features

    @jax.jit
    def batch_metric(labels, mask, scores):
        # scores [B, D, C] → per-query metric [B, C]
        return jax.vmap(
            lambda s: scorer.score_from_scores(labels, s, mask),
            in_axes=2, out_axes=1)(scores)

    # present feature lists per query
    present = []
    for qi in range(Q):
        s, e = int(ds.indptr[ds.qrow[qi]]), int(ds.indptr[ds.qrow[qi + 1]])
        f = np.unique(ds.fids[s:e])
        present.append(f[f < F].astype(np.int64))

    # m0 per query (zero scores) — one batched call per size class
    S = np.empty((Q, F), np.float32)
    groups = {}
    for qi, q in enumerate(ds.queries):
        groups.setdefault(padded_size(q.n), []).append(qi)
    # bound the [B, D, C] score block (f32) to ~256 MB
    budget = 1 << 26
    for D, idxs in sorted(groups.items()):
        labs = np.zeros((len(idxs), D), np.float32)
        msk = np.zeros((len(idxs), D), bool)
        for b, qi in enumerate(idxs):
            q = ds.queries[qi]
            labs[b, : q.n] = q.labels
            msk[b, : q.n] = True
        m0 = np.asarray(batch_metric(
            jnp.asarray(labs), jnp.asarray(msk),
            jnp.zeros((len(idxs), D, 1), jnp.float32)))[:, 0]
        for b, qi in enumerate(idxs):
            S[qi, :] = m0[b]
        # present pairs: chunk rows so B·D·Cmax stays bounded. Every
        # sub-chunk pads to the SAME (rows, D, Cmax) shape — unpadded
        # sub-chunks retraced batch_metric per distinct (len(sub), Csub)
        # (the tail of every class + per-chunk candidate maxima), each a
        # fresh compile (review finding). Pad rows carry empty masks
        # (metric 0, never read back); pad candidate columns cost bounded
        # wasted flops.
        Cmax = max((len(present[qi]) for qi in idxs), default=0)
        if Cmax == 0:
            continue
        rows = max(1, budget // (D * Cmax))
        rows = min(rows, len(idxs))
        for lo in range(0, len(idxs), rows):
            sub = idxs[lo: lo + rows]
            if all(len(present[qi]) == 0 for qi in sub):
                continue
            sc = np.zeros((rows, D, Cmax), np.float32)
            for b, qi in enumerate(sub):
                fq = present[qi]
                if len(fq):
                    sc[b, : ds.queries[qi].n, : len(fq)] = \
                        ds.materialize_query(qi)[:, fq]
            labs_sub = np.zeros((rows, D), np.float32)
            msk_sub = np.zeros((rows, D), bool)
            labs_sub[: len(sub)] = labs[lo: lo + len(sub)]
            msk_sub[: len(sub)] = msk[lo: lo + len(sub)]
            vals = np.asarray(batch_metric(
                jnp.asarray(labs_sub), jnp.asarray(msk_sub),
                jnp.asarray(sc)))
            for b, qi in enumerate(sub):
                fq = present[qi]
                if len(fq):
                    S[qi, fq] = vals[b, : len(fq)]
    return S


def sparse_mean_metric(scorer: MetricScorer, Wf, chunks, buckets, N,
                       n_queries: int, axis_name: str | None = None):
    """Wf [F, K] → mean metric [K] over all queries (jit-friendly).

    ``axis_name``: set when running per-device inside shard_map
    (-sparse -dp, parallel/dp.py shard_sparse_data) — the per-device
    totals psum before dividing by the GLOBAL query count, so every
    device sees the identical mean."""
    S = sparse_scores_flat(Wf, chunks, N)

    def one_candidate(sc_flat):
        total = jnp.float32(0.0)
        for lab, msk, didx in buckets:
            total += scorer.score_from_scores(lab, sc_flat[didx], msk).sum()
        return total

    totals = jax.vmap(one_candidate, in_axes=1)(S)
    if axis_name:
        totals = jax.lax.psum(totals, axis_name)
    return totals / n_queries
