"""Batched on-device metric evaluation for linear score functions.

Used by Coordinate Ascent (line-search candidates) and AdaRank (per-feature
weak rankers): evaluate the mean metric of MANY candidate weight vectors in
one pass — scores = feats @ W is a single [B·D, F] × [F, C] matmul per
bucket, then the metric is vmapped over the candidate axis.

The reference evaluates one candidate at a time on the CPU
(ref: learning/CoorAscent.java:~100 line search; learning/boosting/
AdaRank.java weak-ranker selection); this redesign is why the search loops
stay host-side but the FLOPs stay on-chip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ranklib_tpu.data.dataset import Dataset, iter_buckets
from ranklib_tpu.metrics.base import MetricScorer


@functools.partial(jax.jit, static_argnames=("scorer",))
def _bucket_candidate_metrics(scorer, feats, labels, mask, W):
    """feats [B,D,F], W [F,C] → per-query metric [B, C]."""
    scores = jnp.einsum("bdf,fc->bdc", feats, W,
                        preferred_element_type=jnp.float32)

    def one_candidate(sc):  # sc: [B, D]
        return scorer.score_from_scores(labels, sc, mask)

    return jax.vmap(one_candidate, in_axes=2, out_axes=1)(scores)


# padded docs per bucket chunk: bounds the [rows, D, C] candidate-score
# temporary to ~256 MB f32 even at C = 512 candidates (rows·D ≤ 2^17)
_DOC_BUDGET = 1 << 17


class LinearMetricEvaluator:
    """Holds a dataset on device, evaluates candidate weight matrices."""

    def __init__(self, ds: Dataset, scorer: MetricScorer):
        self.scorer = scorer
        self.n_queries = len(ds.queries)
        self.n_features = ds.n_features
        self.buckets = []
        for b in iter_buckets(ds):
            rows = max(1, min(b.B, _DOC_BUDGET // b.D))
            for lo in range(0, b.B, rows):
                hi = min(lo + rows, b.B)
                pad = rows - (hi - lo)
                self.buckets.append(
                    (
                        jnp.asarray(np.pad(b.feats[lo:hi],
                                           ((0, pad), (0, 0), (0, 0)))),
                        jnp.asarray(np.pad(b.labels[lo:hi],
                                           ((0, pad), (0, 0)))),
                        jnp.asarray(np.pad(b.mask[lo:hi],
                                           ((0, pad), (0, 0)))),
                        b.qidx[lo:hi],
                    )
                )

    def mean_metric(self, W: np.ndarray) -> np.ndarray:
        """W: [F, C] candidate weights → [C] macro-averaged metric."""
        Wd = jnp.asarray(W, jnp.float32)
        total = np.zeros(W.shape[1], np.float64)
        for feats, labels, mask, _ in self.buckets:
            vals = _bucket_candidate_metrics(self.scorer, feats, labels, mask, Wd)
            total += np.asarray(vals, np.float64).sum(axis=0)
        return total / self.n_queries

    def per_query_metric(self, w: np.ndarray) -> np.ndarray:
        """Single weight vector → per-query metric [Q] (Dataset order)."""
        return self.per_query_matrix(np.asarray(w)[:, None])[:, 0]

    def per_query_matrix(self, W: np.ndarray) -> np.ndarray:
        """W: [F, C] candidate weights → [Q, C] per-query metrics."""
        Wd = jnp.asarray(W, jnp.float32)
        out = np.zeros((self.n_queries, W.shape[1]), np.float64)
        for feats, labels, mask, qidx in self.buckets:
            vals = _bucket_candidate_metrics(self.scorer, feats, labels, mask, Wd)
            out[qidx] = np.asarray(vals)[: len(qidx)]
        return out
