"""Host-side data model and device-side padded batches.

The reference models data as DataPoint objects inside RankList objects
(ref: learning/DataPoint.java:~30, learning/RankList.java:~15). On the
device the object graph dissolves into arrays:

* host side — :class:`Query` (one ranked list: labels[n], feats[n, F]) and
  :class:`Dataset` (file-ordered list of queries);
* device side — :class:`QueryBucket`: queries padded to a common doc count
  D and stacked as ``feats[B, D, F]``, ``labels[B, D]``, ``mask[B, D]``.
  Bucketing by padded size bounds padding waste for the O(D²) pairwise
  work (SURVEY.md §5 "long-context" row: MSLR doc counts reach ~1,200).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ranklib_tpu.utils.errors import RankLibError

# Padded-size ladder; queries above the last edge are padded to a multiple
# of 512. The ladder is DENSE (~1.2× geometric steps) because per-query
# pair work is O(D_pad²): padding a 130-doc query to 256 wastes 4× its pair
# budget. More edges do cost compile variety across datasets; ~1.2× steps
# cap padding waste at ~44% of pair work worst-case.
BUCKET_EDGES = (8, 16, 24, 32, 40, 48, 64, 80, 96, 112, 128, 160, 192,
                224, 256, 320, 384, 448, 512, 640, 768, 896, 1024, 1280,
                1536, 2048)


@dataclass
class Query:
    """One ranked list (the reference's RankList)."""

    qid: str
    labels: np.ndarray          # [n] float32 graded relevance
    feats: np.ndarray           # [n, F] float32, column j = fid j+1
    descs: list = field(default_factory=list)  # per-doc '# ...' descriptions

    @property
    def n(self) -> int:
        return int(self.labels.shape[0])

    def correct_ranking(self) -> np.ndarray:
        """Permutation sorting docs by label desc, stable (ref:
        RankList.getCorrectRanking via MergeSorter — stability defines
        deterministic tie-breaking, utilities/MergeSorter.java:~20)."""
        return np.argsort(-self.labels, kind="stable")


@dataclass
class Dataset:
    queries: list               # list[Query], file order
    n_features: int             # max fid seen (1-indexed width)

    def __len__(self):
        return len(self.queries)

    def __iter__(self):
        return iter(self.queries)

    @property
    def n_docs(self) -> int:
        return sum(q.n for q in self.queries)

    def subset_features(self, fids) -> "Dataset":
        """Restrict to a feature subset, keeping column positions (unlisted
        features read as 0 — matches training on a `-feature` subset where
        the model still addresses original fids)."""
        keep = feature_mask_from_fids(fids, self.n_features)
        out = []
        for q in self.queries:
            feats = np.where(keep[None, :], q.feats, 0.0).astype(np.float32)
            out.append(Query(q.qid, q.labels.copy(), feats, list(q.descs)))
        return Dataset(out, self.n_features)

    def with_width(self, n_features: int) -> "Dataset":
        """Pad or clip every query's feature block to exactly
        ``n_features`` columns. Used to align validation/test/rank files
        to a training (or loaded-model) width: the reference parses all
        files into one global fid space (DataPoint.featureCount) where
        fids the model never references are simply unused — clipping the
        extra columns is behaviorally identical, and padding mirrors
        missing-fid-reads-as-0."""
        if n_features == self.n_features:
            return self
        out = []
        for q in self.queries:
            feats = q.feats[:, :n_features]
            if feats.shape[1] < n_features:
                feats = np.pad(feats,
                               ((0, 0), (0, n_features - feats.shape[1])))
            out.append(Query(q.qid, q.labels, np.ascontiguousarray(feats),
                             q.descs))
        return Dataset(out, n_features)

    def all_fids(self):
        """All fids 1..F (ref: FeatureManager.getFeatureFromSampleVector)."""
        return list(range(1, self.n_features + 1))


def feature_mask_from_fids(fids, n_features: int) -> np.ndarray:
    """[F] bool mask from 1-indexed fids (a ``-feature`` file), with the
    shared out-of-range error — the ONE copy of this validation
    (Dataset.subset_features, CSRDataset.subset_features, and the
    evaluator's streamed-mask path all consume it; review finding,
    round 5: three drifting copies)."""
    mask = np.zeros(n_features, dtype=bool)
    for fid in fids:
        if fid < 1 or fid > n_features:
            raise RankLibError(
                f"Feature id {fid} out of range 1..{n_features}")
        mask[fid - 1] = True
    return mask


def read_feature_file(path: str):
    """Feature-subset file: one fid per line, '#' comments
    (ref: FeatureManager.readFeature, features/FeatureManager.java:~350)."""
    fids = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                fids.append(int(line))
    return fids


@dataclass
class QueryBucket:
    """A stack of queries padded to the same doc count (device-friendly)."""

    feats: np.ndarray       # [B, D, F] float32
    labels: np.ndarray      # [B, D] float32 (padding = 0)
    mask: np.ndarray        # [B, D] bool (True = real doc)
    qidx: np.ndarray        # [B] int32 — index of the query in Dataset.queries
    n_docs: np.ndarray      # [B] int32 — true doc counts

    @property
    def B(self) -> int:
        return int(self.labels.shape[0])

    @property
    def D(self) -> int:
        return int(self.labels.shape[1])


def padded_size(n: int) -> int:
    for e in BUCKET_EDGES:
        if n <= e:
            return e
    return ((n + 511) // 512) * 512


def bucketize(ds: Dataset, with_feats: bool = True) -> list:
    """Eager list of :func:`iter_buckets` — fine for dense datasets and
    feats-free consumers. CSR consumers that materialize dense chunks
    should iterate :func:`iter_buckets` instead: an eager list holds
    EVERY chunk's dense block simultaneously, defeating the one-chunk
    host bound (review finding)."""
    return list(iter_buckets(ds, with_feats))


def iter_buckets(ds: Dataset, with_feats: bool = True):
    """Group queries into :class:`QueryBucket`\\ s by padded doc count
    (generator).

    Query order inside a bucket follows file order; macro-averaged metrics
    are order-independent so bucketing never changes results.

    CSR datasets (``data.sparse.CSRDataset``: feats live in host CSR, not
    on the Query objects) are materialized here in bounded CHUNKS — each
    yielded bucket's dense block stays under the sparse chunk budget, so
    the peak host allocation is one chunk instead of [N, F] — PROVIDED
    the caller consumes buckets one at a time (upload/score, then drop).
    Chunking splits a size class into more buckets but preserves query
    order, so sequential consumers (the neural per-query SGD scan) visit
    queries in exactly the dense pipeline's order.
    """
    groups = {}
    for qi, q in enumerate(ds.queries):
        groups.setdefault(padded_size(q.n), []).append(qi)
    sparse = with_feats and hasattr(ds, "materialize_query")
    if sparse:
        from ranklib_tpu.data.sparse import _chunk_bytes
        rows_cap_bytes = _chunk_bytes()
    for D in sorted(groups):
        idxs_all = groups[D]
        if sparse:
            # max(1, F): a zero-feature file ('2 qid:1' lines) parses
            # in both pipelines — don't ZeroDivisionError here
            rows = max(1, rows_cap_bytes // (D * max(1, ds.n_features) * 4))
            chunks = [idxs_all[i: i + rows]
                      for i in range(0, len(idxs_all), rows)]
        else:
            chunks = [idxs_all]
        for idxs in chunks:
            B = len(idxs)
            labels = np.zeros((B, D), dtype=np.float32)
            mask = np.zeros((B, D), dtype=bool)
            n_docs = np.zeros((B,), dtype=np.int32)
            feats = (np.zeros((B, D, ds.n_features), dtype=np.float32)
                     if with_feats else None)
            for b, qi in enumerate(idxs):
                q = ds.queries[qi]
                labels[b, : q.n] = q.labels
                mask[b, : q.n] = True
                n_docs[b] = q.n
                if with_feats:
                    feats[b, : q.n] = (ds.materialize_query(qi) if sparse
                                       else q.feats)
            yield QueryBucket(feats=feats, labels=labels, mask=mask,
                              qidx=np.asarray(idxs, dtype=np.int32),
                              n_docs=n_docs)


def flatten_meta(ds: Dataset):
    """labels[N] f32 + qptr[Q+1] — :func:`flatten` without materializing
    the feature matrix (also serves feats-free binned datasets)."""
    N = ds.n_docs
    labels = np.empty((N,), dtype=np.float32)
    qptr = np.zeros((len(ds.queries) + 1,), dtype=np.int64)
    pos = 0
    for i, q in enumerate(ds.queries):
        labels[pos: pos + q.n] = q.labels
        pos += q.n
        qptr[i + 1] = pos
    return labels, qptr


def flatten(ds: Dataset):
    """Flat doc-major arrays for GBDT: feats[N, F], labels[N], qptr[Q+1].

    (The reference's LambdaMART.init flattens all docs into martSamples[] —
    ref: learning/tree/LambdaMART.java:~40.)
    """
    N = ds.n_docs
    feats = np.empty((N, ds.n_features), dtype=np.float32)
    labels = np.empty((N,), dtype=np.float32)
    qptr = np.zeros((len(ds.queries) + 1,), dtype=np.int64)
    pos = 0
    for i, q in enumerate(ds.queries):
        feats[pos : pos + q.n] = q.feats
        labels[pos : pos + q.n] = q.labels
        pos += q.n
        qptr[i + 1] = pos
    return feats, labels, qptr


def query_feats(ds: Dataset, qi: int) -> np.ndarray:
    """Raw [n, F] feature block of query ``qi`` — direct for dense
    datasets, materialized on demand for CSR ones. Raises for bin-only
    datasets (the streaming GBDT representation has no raw values)."""
    q = ds.queries[qi]
    if q.feats is not None:
        return q.feats
    if hasattr(ds, "materialize_query"):
        return ds.materialize_query(qi)
    raise RankLibError(
        "dataset carries no raw feature values (streamed bin matrix); "
        "use the dense or CSR pipeline for this ranker")
