"""Host-CSR dataset for wide/sparse inputs feeding RAW-VALUE rankers.

The streaming parse→bin loader (data.binned) serves the GBDT family,
which only consumes bin ids — but neural, linear, Coordinate Ascent and
AdaRank train on raw feature VALUES, and routing them through the dense
pipeline materializes the full ``[N, F]`` float32 matrix: the host-RAM
wall the reference avoids with storage-level sparse vectors
(ref: learning/SparseDataPoint.java:~15 fid[]/val[] arrays).

This module is the array-shaped equivalent: the file lands in host CSR
(``indptr``/``fids``/``vals`` — memory ~ nnz), and dense blocks are
materialized ON DEMAND in bounded chunks:

* :func:`ranklib_tpu.data.dataset.bucketize` detects a CSRDataset and
  yields bucket CHUNKS whose dense block stays under
  ``SPARSE_CHUNK_BYTES`` (env ``RANKLIB_TPU_SPARSE_CHUNK_MB``), so the
  peak host allocation is one chunk, never the whole matrix. Training
  loops iterate buckets anyway — chunking preserves query visit order
  bit-for-bit (pinned by the parity tests).
* Linear regression accumulates its f64 normal equations chunk by chunk
  (models/linear.py) — the Gram matrix is [F+1, F+1], never [N, F].
* Per-query scoring paths materialize one query at a time.

DEVICE footprint: Coordinate Ascent and AdaRank route through the
embedding-style gather/segment-sum layer (ops/sparse_eval.py) when dense
bucket residency would exceed the device-memory budget
(RANKLIB_TPU_DEVICE_DENSE_MB): CA evaluates line-search candidates
against the device COO; AdaRank builds its weak-metric matrix sparsely
(absent features reuse the query's zero-score metric) and scores the
strong model through the same layer. AdaRank's remaining ceiling is the
S[Q, F] matrix itself (one weak metric per (query, feature) is inherent
to the algorithm — Q·F floats, far below N·F). The neural first layer
rides the same gather/segment-sum primitive (models/neural.py
_forward_sparse). RankBoost's remaining wide ceiling is its device bin
matrix ([F, N] int32 — the weak search is an all-features histogram).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ranklib_tpu.data.dataset import Dataset, Query
from ranklib_tpu.data.letor import _desc_pos
from ranklib_tpu.utils.errors import RankLibError
from ranklib_tpu.utils.logging import log


def _chunk_bytes() -> int:
    mb = os.environ.get("RANKLIB_TPU_SPARSE_CHUNK_MB", "256")
    try:
        return max(1, int(mb)) << 20
    except ValueError:
        return 256 << 20


@dataclass
class CSRDataset(Dataset):
    """A feats-free Dataset plus host CSR storage of the raw values.

    ``queries[i].feats is None``; rows are docs in query file order.
    """

    indptr: np.ndarray = None    # [N+1] int64 — per-doc pair ranges
    fids: np.ndarray = None      # [nnz] int32, 0-based feature ids
    vals: np.ndarray = None      # [nnz] float32
    qrow: np.ndarray = None      # [Q+1] int64 — query → doc-row range
    # lazy per-query normalization (see normalize_csr): materialization
    # applies the EXACT dense formula elementwise, so trained models stay
    # bit-identical to the dense pipeline's. Stats are stored SPARSELY —
    # only the features PRESENT in a query carry one (an all-implicit-zero
    # column's dense stats are exactly (0, 0), which every scheme maps to
    # 'leave the 0s alone'), so stat memory is ~nnz instead of the [Q, F]
    # arrays that capped extreme widths at ~24 GB (30K queries × 100K
    # features).
    norm_kind: str | None = None
    ns_indptr: np.ndarray = None  # [Q+1] int64 — per-query stat ranges
    ns_fids: np.ndarray = None    # [S] int32 0-based fids carrying stats
    ns_a: np.ndarray = None       # [S] f32 (μ / Σ|v| / min)
    ns_b: np.ndarray = None       # [S] f32 (σ / unused / range)
    ns_width: int = 0             # feature width the stats were computed at

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def _apply_norm(self, out: np.ndarray, lo: int, hi: int) -> np.ndarray:
        """Dense block [hi-lo, width] of doc rows [lo, hi) → normalized,
        using each row's query stats. Columns beyond the stats' width
        (added by with_width AFTER normalization) stay 0, matching the
        dense order norm-then-widen; columns with no stat entry are
        all-zero by construction and every scheme leaves them 0."""
        Fn = min(self.ns_width, out.shape[1])
        qi = int(np.searchsorted(self.qrow, lo, side="right") - 1)
        while qi < len(self.queries) and self.qrow[qi] < hi:
            r0 = int(max(self.qrow[qi], lo) - lo)
            r1 = int(min(self.qrow[qi + 1], hi) - lo)
            s, e = int(self.ns_indptr[qi]), int(self.ns_indptr[qi + 1])
            f = self.ns_fids[s:e]
            sel = f < Fn
            f = f[sel]
            a = self.ns_a[s:e][sel]
            block = out[r0:r1]
            if self.norm_kind == "sum":
                pos = a > 0
                block[:, f[pos]] = block[:, f[pos]] / a[pos]
            else:
                # zscore and linear share one affine form: (v − A)/B with
                # B > 0, else 0 — A/B already encode (μ, σ) vs (min, range)
                b = self.ns_b[s:e][sel]
                bp = b > 0
                block[:, f[bp]] = (block[:, f[bp]] - a[bp]) / b[bp]
                block[:, f[~bp]] = 0.0
            qi += 1
        return out

    # ---- dense materialization (bounded by the caller) ---------------------
    def materialize_rows(self, lo: int, hi: int,
                         width: int | None = None) -> np.ndarray:
        """Dense [hi-lo, width] block of doc rows [lo, hi). Duplicate fids
        on one line keep last-wins semantics like the dense parser's
        overwrite; fids ≥ width are clipped (unusable by the model)."""
        F = int(width if width is not None else self.n_features)
        out = np.zeros((hi - lo, F), np.float32)
        s, e = int(self.indptr[lo]), int(self.indptr[hi])
        if e > s:
            rows = np.repeat(np.arange(hi - lo),
                             np.diff(self.indptr[lo: hi + 1]))
            f = self.fids[s:e]
            keep = f < F
            out[rows[keep], f[keep]] = self.vals[s:e][keep]
        if self.norm_kind is not None:
            out = self._apply_norm(out, lo, hi)
        return out

    def materialize_query(self, qi: int,
                          width: int | None = None) -> np.ndarray:
        return self.materialize_rows(int(self.qrow[qi]),
                                     int(self.qrow[qi + 1]), width)

    # ---- Dataset contract overrides ----------------------------------------
    def subset_queries(self, idxs) -> "CSRDataset":
        """New CSRDataset of the given query indices (file order of idxs)."""
        idxs = list(idxs)
        counts = np.diff(self.indptr)
        row_chunks, fid_chunks, val_chunks, queries = [], [], [], []
        ns_f, ns_a, ns_b, ns_counts = [], [], [], []
        for qi in idxs:
            lo, hi = int(self.qrow[qi]), int(self.qrow[qi + 1])
            row_chunks.append(counts[lo:hi])
            s, e = int(self.indptr[lo]), int(self.indptr[hi])
            fid_chunks.append(self.fids[s:e])
            val_chunks.append(self.vals[s:e])
            queries.append(self.queries[qi])
            if self.norm_kind is not None:
                u, v = int(self.ns_indptr[qi]), int(self.ns_indptr[qi + 1])
                ns_f.append(self.ns_fids[u:v])
                ns_a.append(self.ns_a[u:v])
                if self.ns_b is not None:
                    ns_b.append(self.ns_b[u:v])
                ns_counts.append(v - u)
        new_counts = (np.concatenate(row_chunks) if row_chunks
                      else np.zeros(0, np.int64))
        indptr = np.zeros(len(new_counts) + 1, np.int64)
        np.cumsum(new_counts, out=indptr[1:])
        qrow = np.zeros(len(idxs) + 1, np.int64)
        np.cumsum([q.n for q in queries], out=qrow[1:])
        kw = {}
        if self.norm_kind is not None:
            ns_indptr = np.zeros(len(idxs) + 1, np.int64)
            np.cumsum(ns_counts, out=ns_indptr[1:])
            kw = dict(
                ns_indptr=ns_indptr,
                ns_fids=(np.concatenate(ns_f) if ns_f
                         else np.zeros(0, np.int32)),
                ns_a=(np.concatenate(ns_a) if ns_a
                      else np.zeros(0, np.float32)),
                ns_b=(np.concatenate(ns_b) if ns_b
                      else None),
                ns_width=self.ns_width)
        return CSRDataset(
            queries=queries, n_features=self.n_features, indptr=indptr,
            fids=(np.concatenate(fid_chunks) if fid_chunks
                  else np.zeros(0, np.int32)),
            vals=(np.concatenate(val_chunks) if val_chunks
                  else np.zeros(0, np.float32)),
            qrow=qrow, norm_kind=self.norm_kind, **kw)

    def subset_features(self, fids) -> "CSRDataset":
        from ranklib_tpu.data.dataset import feature_mask_from_fids

        keep = feature_mask_from_fids(fids, self.n_features)
        # stored fids can exceed n_features after with_width narrowing
        # (materialize_rows clips them; they are dropped here the same way)
        inw = self.fids < self.n_features
        sel = keep[np.minimum(self.fids, self.n_features - 1)] & inw
        # per-row kept counts via a cumsum sampled at row boundaries —
        # O(nnz) with no materialized [nnz] row-id array (np.add.at over
        # np.repeat was 10-100x slower on 100M+-nnz files — review
        # finding)
        cs = np.concatenate([[0], np.cumsum(sel, dtype=np.int64)])
        indptr = cs[self.indptr]
        # a subset AFTER normalization must drop the removed columns'
        # transforms too (the dense pipeline zeroes normalized values;
        # dropping the stat entry leaves the column's materialized 0s
        # untouched — the same result)
        kw = {}
        if self.norm_kind is not None:
            # stats can be wider than the current width (norm before a
            # narrowing with_width): pad the keep mask with False — those
            # columns never materialize anyway
            keep_n = np.zeros(max(self.ns_width, len(keep)), bool)
            keep_n[: len(keep)] = keep
            ns_sel = keep_n[self.ns_fids]
            ns_cs = np.concatenate([[0], np.cumsum(ns_sel, dtype=np.int64)])
            ns_indptr = ns_cs[self.ns_indptr]
            kw = dict(
                ns_indptr=ns_indptr, ns_fids=self.ns_fids[ns_sel],
                ns_a=self.ns_a[ns_sel],
                ns_b=(self.ns_b[ns_sel] if self.ns_b is not None
                      else None),
                ns_width=self.ns_width)
        return CSRDataset(
            queries=self.queries, n_features=self.n_features,
            indptr=indptr, fids=self.fids[sel], vals=self.vals[sel],
            qrow=self.qrow, norm_kind=self.norm_kind, **kw)

    def with_width(self, n_features: int) -> "CSRDataset":
        """Width change matching the dense pipeline's DESTRUCTIVE clip.

        Widening is a pure metadata change (implicit columns read 0).
        Narrowing physically DROPS stored entries with fid ≥ width — a
        metadata-only narrow let ``with_width(50).with_width(80)``
        resurrect the clipped fids 51..80 with their raw (and, after a
        narrow-width normalize, unnormalized) values, silently diverging
        from the dense pipeline where the columns are sliced away
        (review finding, round 5)."""
        if n_features == self.n_features:
            return self
        if n_features < self.n_features:
            sel = self.fids < n_features
            cs = np.concatenate([[0], np.cumsum(sel, dtype=np.int64)])
            indptr = cs[self.indptr]
            kw = {}
            if self.norm_kind is not None:
                ns_sel = self.ns_fids < n_features
                ns_cs = np.concatenate(
                    [[0], np.cumsum(ns_sel, dtype=np.int64)])
                ns_indptr = ns_cs[self.ns_indptr]
                kw = dict(ns_indptr=ns_indptr,
                          ns_fids=self.ns_fids[ns_sel],
                          ns_a=self.ns_a[ns_sel],
                          ns_b=(self.ns_b[ns_sel]
                                if self.ns_b is not None else None),
                          ns_width=min(self.ns_width, n_features))
            return CSRDataset(queries=self.queries, n_features=n_features,
                              indptr=indptr, fids=self.fids[sel],
                              vals=self.vals[sel], qrow=self.qrow,
                              norm_kind=self.norm_kind, **kw)
        return CSRDataset(queries=self.queries, n_features=n_features,
                          indptr=self.indptr, fids=self.fids,
                          vals=self.vals, qrow=self.qrow,
                          norm_kind=self.norm_kind,
                          ns_indptr=self.ns_indptr, ns_fids=self.ns_fids,
                          ns_a=self.ns_a, ns_b=self.ns_b,
                          ns_width=self.ns_width)


def _py_parse_csr(path: str):
    """Python fallback (no g++ / oversized tokens): same outputs as
    native_parse_letor_csr."""
    import gzip

    labels, counts, qids = [], [], []
    fid_chunks, val_chunks, starts = [], [], []
    prev_qid = None
    max_fid = 0
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        for ln, line in enumerate(fh, 1):
            hp = _desc_pos(line)         # token-boundary '#' only (native rule)
            body = (line[:hp] if hp >= 0 else line).strip()
            if not body:
                continue
            toks = body.split()
            if len(toks) < 2 or not toks[1].startswith("qid:"):
                raise RankLibError(f"{path}:{ln}: malformed line")
            try:
                label = float(toks[0])
            except ValueError:
                raise RankLibError(f"{path}:{ln}: bad label {toks[0]!r}")
            if label < 0:
                raise RankLibError(f"{path}:{ln}: negative label")
            qid = toks[1][4:]
            row_f, row_v = [], []
            for tok in toks[2:]:
                fid_s, _, val_s = tok.partition(":")
                try:
                    fid = int(fid_s)
                    val = float(val_s)
                except ValueError:
                    raise RankLibError(f"{path}:{ln}: bad pair {tok!r}")
                if fid <= 0:
                    raise RankLibError(f"{path}:{ln}: fid must be >= 1")
                row_f.append(fid - 1)
                row_v.append(val)
                max_fid = max(max_fid, fid)
            labels.append(label)
            counts.append(len(row_f))
            fid_chunks.append(row_f)
            val_chunks.append(row_v)
            if qid != prev_qid:
                qids.append(qid)
                starts.append(len(labels) - 1)
                prev_qid = qid
    if not labels:
        raise RankLibError(f"No queries read from {path}")
    qptr = np.asarray(starts + [len(labels)], np.int64)
    counts = np.asarray(counts, np.int32)
    indptr = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    fids = np.asarray([f for row in fid_chunks for f in row], np.int32)
    vals = np.asarray([v for row in val_chunks for v in row], np.float32)
    return (np.asarray(labels, np.float32), qptr, qids, indptr, fids, vals,
            counts, max_fid)


def read_letor_sparse(path: str, must_have_rel_doc: bool = False,
                      n_features: int | None = None,
                      missing_zero: bool = True,
                      quiet: bool = False,
                      want_descs: bool = False) -> CSRDataset:
    """Stream a LETOR file into a :class:`CSRDataset` (native parser when
    available, Python fallback otherwise; gzip via streamed temp
    decompression like the dense native path).

    ``want_descs`` additionally streams the per-doc '#' descriptions and
    attaches them to the Query objects — what ``-qrel`` (docid matching)
    and ``-indri`` (docid output) need for dense-pipeline parity (ref:
    learning/SparseDataPoint.java:~15 keeps the description). Off by
    default: the desc side-array is the one per-doc Python-object cost
    this loader otherwise avoids."""
    from ranklib_tpu.data.letor import read_descs
    from ranklib_tpu.native.loader import (
        NativeParseError, native_parse_letor_csr,
    )

    parsed = None
    descs = None
    if path.endswith(".gz"):
        from ranklib_tpu.native.loader import gunzip_to_temp

        tmp_path = gunzip_to_temp(path)
        try:
            try:
                parsed = native_parse_letor_csr(tmp_path)
            except NativeParseError:
                parsed = None
            if parsed is None:
                parsed = _py_parse_csr(tmp_path)
            if want_descs:
                descs = read_descs(tmp_path, int(parsed[1][-1]))
        finally:
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
    else:
        try:
            parsed = native_parse_letor_csr(path)
        except NativeParseError:
            parsed = None
        if parsed is None:
            parsed = _py_parse_csr(path)
        if want_descs:
            descs = read_descs(path, int(parsed[1][-1]))
    labels, qptr, qids, indptr, fids, vals, counts, max_fid = parsed

    if not missing_zero:
        from ranklib_tpu.data.letor import _check_fully_specified
        _check_fully_specified(path, counts, max_fid, qptr, qids)

    F = max(int(max_fid), int(n_features or 0))
    queries = []
    qrow = [0]
    for i, qid in enumerate(qids):
        s, e = int(qptr[i]), int(qptr[i + 1])
        queries.append(Query(qid=qid, labels=labels[s:e], feats=None,
                             descs=(descs[s:e] if descs is not None
                                    else [])))
        qrow.append(e)
    ds = CSRDataset(queries=queries, n_features=F,
                    indptr=indptr, fids=fids, vals=vals,
                    qrow=np.asarray(qrow, np.int64))
    if must_have_rel_doc:
        keep = [i for i, q in enumerate(ds.queries) if (q.labels > 0).any()]
        if not keep:
            raise RankLibError(f"No queries with a relevant doc in {path}")
        if len(keep) < len(ds.queries):
            if not quiet:
                log(f"[-sparse] dropped {len(ds.queries) - len(keep)} "
                    f"queries with no relevant doc")
            ds = ds.subset_queries(keep)
    if not quiet:
        dense_mb = ds.n_docs * F * 4 / (1 << 20)
        csr_mb = (ds.nnz * 8 + ds.n_docs * 8) / (1 << 20)
        log(f"(CSR: {len(ds.queries)} ranked lists, {ds.n_docs} entries, "
            f"{ds.nnz} stored values — {csr_mb:.0f} MB vs "
            f"{dense_mb:.0f} MB dense)")
    return ds


def normalize_csr(ds: CSRDataset, name: str) -> CSRDataset:
    """Per-query normalization on a CSRDataset — LAZY: the per-query
    statistics are computed here (one query materialized at a time, on
    raw values — identical numpy reductions over identical arrays to the
    dense pipeline's q.feats, so the floats are bit-equal), and
    :meth:`CSRDataset.materialize_rows` applies the EXACT dense formula
    elementwise at materialization. Trained models are bit-identical to
    the dense pipeline's (tests/test_sparse_csr.py).

    Stats are STORED sparsely — only the features present in a query
    carry an entry (an all-implicit-zero column's stats are exactly
    (0, 0), which every scheme maps to 'leave the 0s alone'), so stat
    memory is ~nnz instead of [Q, F] (the round-3 ceiling for extreme
    widths). Transient memory is one query's dense block at a time.
    """
    from ranklib_tpu.data.normalize import get_normalizer

    get_normalizer(name)                     # validate the name
    if ds.norm_kind is not None:
        raise RankLibError("dataset is already normalized")
    kind = name.lower()
    Q, F = len(ds.queries), ds.n_features
    ns_counts = np.zeros(Q, np.int64)
    f_chunks, a_chunks, b_chunks = [], [], []
    for qi in range(Q):
        feats = ds.materialize_query(qi)
        if kind == "sum":
            arow = np.abs(feats).sum(axis=0)
            brow = None
        elif kind == "zscore":
            arow = feats.mean(axis=0)
            brow = feats.std(axis=0)         # population σ, like the dense
        else:                                # linear
            arow = feats.min(axis=0)
            brow = feats.max(axis=0) - arow
        s, e = (int(ds.indptr[ds.qrow[qi]]),
                int(ds.indptr[ds.qrow[qi + 1]]))
        f = np.unique(ds.fids[s:e])
        f = f[f < F].astype(np.int32)
        ns_counts[qi] = len(f)
        f_chunks.append(f)
        a_chunks.append(arow[f].astype(np.float32))
        if brow is not None:
            b_chunks.append(brow[f].astype(np.float32))
    ns_indptr = np.zeros(Q + 1, np.int64)
    np.cumsum(ns_counts, out=ns_indptr[1:])
    return CSRDataset(
        queries=ds.queries, n_features=F, indptr=ds.indptr,
        fids=ds.fids, vals=ds.vals, qrow=ds.qrow, norm_kind=kind,
        ns_indptr=ns_indptr,
        ns_fids=(np.concatenate(f_chunks) if f_chunks
                 else np.zeros(0, np.int32)),
        ns_a=(np.concatenate(a_chunks) if a_chunks
              else np.zeros(0, np.float32)),
        ns_b=(np.concatenate(b_chunks) if b_chunks else None),
        ns_width=F)
