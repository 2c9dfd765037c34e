"""Linear Regression ranker (`-ranker 9`).

Pointwise least squares of labels on features with ridge regularization
(ref: learning/LinearRegRank.java:~25 — builds XᵀX and Xᵀy then solves by
Gaussian elimination with lambda 1e-10 on the diagonal).

Array shape: the normal equations are accumulated as one batched
matmul over all docs (an [N, F+1]ᵀ[N, F+1] Gram matrix);
the tiny (F+1)² solve runs on host in float64, matching the reference's
double precision. Model format: '0:<intercept> 1:<w1> ...' (index 0 is the
intercept; feature fids are 1-indexed).
"""

from __future__ import annotations

import numpy as np

from ranklib_tpu.data.dataset import Dataset, flatten
from ranklib_tpu.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu.utils.errors import RankLibError
from ranklib_tpu.utils.logging import log


@register_ranker
class LinearRegRank(Ranker):
    NAME = "Linear Regression"

    def __init__(self, **hp):
        self.lam = 1e-10          # ridge lambda (ref flag -L2, default 1e-10)
        self.weights = None       # np.float64 [F + 1]; [0] = intercept
        super().__init__(**hp)

    def fit(self, train: Dataset, scorer=None, validation=None):
        if (train.queries and train.queries[0].feats is None
                and hasattr(train, "materialize_rows")):
            # CSR (-sparse): chunked f64 normal equations — the Gram
            # matrix is [F+1, F+1]; the dense [N, F] block never
            # materializes (data/sparse.py)
            from ranklib_tpu.data.dataset import flatten_meta
            from ranklib_tpu.data.sparse import _chunk_bytes

            F = train.n_features
            labels, _ = flatten_meta(train)
            N = train.n_docs
            # chunk budget counts BOTH live blocks: the f32 materialized
            # rows (4 B/elem) and their f64 design-matrix copy (8 B/elem)
            rows = max(1, _chunk_bytes() // (F * 12))
            xtx = np.zeros((F + 1, F + 1), np.float64)
            xty = np.zeros((F + 1,), np.float64)
            for lo in range(0, N, rows):
                hi = min(lo + rows, N)
                X = np.empty((hi - lo, F + 1), np.float64)
                X[:, 0] = 1.0
                X[:, 1:] = train.materialize_rows(lo, hi)
                xtx += X.T @ X
                xty += X.T @ labels[lo:hi].astype(np.float64)
        else:
            feats, labels, _ = flatten(train)
            N, F = feats.shape
            X = np.concatenate([np.ones((N, 1), np.float32), feats], axis=1)
            # f64 normal equations always (the reference solves in
            # double; a device matmul at default precision rounds
            # operands to bf16 and visibly skews the ill-conditioned
            # ridge solve — review finding). Large N chunks the f64 cast,
            # not the math: XᵀX accumulates exactly like the CSR branch.
            xtx = np.zeros((F + 1, F + 1), np.float64)
            xty = np.zeros((F + 1,), np.float64)
            lab64 = labels.astype(np.float64)
            rows = max(1, (1 << 22) // (F + 1))
            for lo in range(0, N, rows):
                Xd = X[lo: lo + rows].astype(np.float64)
                xtx += Xd.T @ Xd
                xty += Xd.T @ lab64[lo: lo + rows]
        xtx[np.diag_indices_from(xtx)] += self.lam
        try:
            self.weights = np.linalg.solve(xtx, xty)
        except np.linalg.LinAlgError as e:
            raise RankLibError("Normal equations are singular") from e
        if scorer is not None:
            log(f"{scorer.name} on training data: "
                f"{self.score_metric(train, scorer):.4f}")

    def eval_dataset(self, ds: Dataset):
        from ranklib_tpu.data.dataset import query_feats

        w = self.weights
        if w is None:
            raise RankLibError("Model not trained/loaded")
        wf = np.zeros(ds.n_features + 1, np.float64)
        wf[: min(len(w), len(wf))] = w[: len(wf)]
        return [query_feats(ds, qi) @ wf[1:].astype(np.float32)
                + np.float32(wf[0]) for qi in range(len(ds.queries))]

    def model_str(self) -> str:
        body = " ".join(f"{i}:{self.weights[i]}" for i in range(len(self.weights)))
        return model_header(self.NAME, {"Lambda": self.lam}) + body + "\n"

    def load_str(self, text: str) -> None:
        params, body = parse_model_params(text)
        if "Lambda" in params:
            self.lam = float(params["Lambda"])
        if not body:
            raise RankLibError("Empty Linear Regression model body")
        pairs = body[0].split()
        max_id = max(int(p.split(":")[0]) for p in pairs)
        w = np.zeros(max_id + 1, np.float64)
        for p in pairs:
            i, _, v = p.partition(":")
            w[int(i)] = float(v)
        self.weights = w
