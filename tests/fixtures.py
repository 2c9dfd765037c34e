"""Synthetic LETOR fixtures.

No LETOR datasets ship with this repo, so tests and benchmarks generate
deterministic synthetic data shaped like MQ2008 (46 features, ~8-120 docs
per query, graded labels 0-2) or MSLR (136 features, labels 0-4). Labels
are drawn so that a planted linear signal exists — rankers must be able to
beat random ordering, which gives the tests teeth.
"""

from __future__ import annotations

import numpy as np

from ranklib_tpu.data.dataset import Dataset, Query


def synth_dataset(
    n_queries: int = 20,
    n_features: int = 46,
    min_docs: int = 5,
    max_docs: int = 40,
    gmax: int = 2,
    seed: int = 0,
    signal: float = 2.0,
    w_seed: int | None = None,
    nonlinear: bool = False,
) -> Dataset:
    """``w_seed`` pins the planted signal so train/test sets drawn with
    different ``seed`` values still share the same ground-truth ranker.

    ``nonlinear=True`` plants threshold/interaction structure (axis-aligned
    regions + pairwise products) instead of a dense linear signal — the
    regime where tree rankers should dominate linear ones."""
    rng = np.random.default_rng(seed)
    w_rng = np.random.default_rng(seed if w_seed is None else w_seed)
    w_true = w_rng.normal(size=n_features)
    w_true /= np.linalg.norm(w_true)
    k = max(4, n_features // 8)
    nl_idx = w_rng.permutation(n_features)[: 2 * k]
    nl_thr = w_rng.normal(size=k) * 0.5
    nl_w = w_rng.normal(size=k)
    pair_w = w_rng.normal(size=k)
    queries = []
    for qi in range(n_queries):
        n = int(rng.integers(min_docs, max_docs + 1))
        feats = rng.normal(size=(n, n_features)).astype(np.float32)
        if nonlinear:
            a = feats[:, nl_idx[:k]]
            b = feats[:, nl_idx[k:]]
            raw = signal * ((a > nl_thr) @ nl_w + (a * b) @ pair_w) \
                / np.sqrt(2 * k) + rng.normal(size=n)
        else:
            raw = signal * feats @ w_true + rng.normal(size=n)
        # map continuous raw score to graded labels 0..gmax by quantile
        qtiles = np.quantile(raw, np.linspace(0, 1, gmax + 2)[1:-1])
        labels = np.digitize(raw, qtiles).astype(np.float32)
        queries.append(Query(qid=str(qi + 1), labels=labels, feats=feats,
                             descs=["" for _ in range(n)]))
    return Dataset(queries, n_features)


def write_letor_text(ds: Dataset, path) -> None:
    with open(path, "w") as f:
        for q in ds.queries:
            for i in range(q.n):
                feats = " ".join(
                    f"{j + 1}:{q.feats[i, j]:.6g}" for j in range(q.feats.shape[1])
                )
                f.write(f"{int(q.labels[i])} qid:{q.qid} {feats} # doc{q.qid}_{i}\n")


# MSLR-WEB10K published marginals (dataset page / LETOR 4.0 papers):
# graded labels are heavily skewed toward 0, queries average ~120 docs
# with a long right tail, and the 136 features fall into per-stream
# families (body/anchor/title/url/whole-doc × TF/IDF/TF-IDF/BM25/LMIR…)
# that are strongly correlated WITHIN a family plus a handful of
# query-independent web-graph features (PageRank, URL stats, clicks).
_MSLR_LABEL_PROBS = (0.517, 0.323, 0.133, 0.019, 0.008)
_MSLR_N_FAMILIES = 25          # feature families of ~5 streams each
_MSLR_STREAMS = 5


def mslr_like_dataset(n_queries: int = 100, seed: int = 0,
                      w_seed: int | None = None,
                      mean_docs: float = 120.0) -> Dataset:
    """Synthetic data matching MSLR-WEB10K's published statistics
    (the real-data-shaped quality gate).

    * labels 0–4 with the WEB10K skew (≈52/32/13/2/1 %), assigned by
      GLOBAL thresholds on a noisy per-doc relevance latent, so per-query
      label mixes vary like the real data (some queries have no relevant
      docs at all);
    * doc counts per query: log-normal, mean ≈ ``mean_docs``, clipped to
      [8, 1000] — the long right tail that stresses the padded-bucket
      ladder;
    * 136 features = 25 families × ~5 streams: one family latent per
      (query, family) mixes the doc relevance signal (families carry it
      with different strengths, like TF/BM25 families vs URL-depth) and
      per-stream transforms add heavy tails (log-normal TF-like counts),
      [0,1] normalizations, and integer quantization (click-ish counts).
      Within-family correlation is high, across-family low — matching the
      redundancy structure real LTR models exploit.
    """
    rng = np.random.default_rng(seed)
    w_rng = np.random.default_rng(seed if w_seed is None else w_seed)
    F = 136
    fam_of = np.arange(F) % _MSLR_N_FAMILIES
    # family signal strengths: a few strong (BM25-like), many weak/noise
    fam_strength = np.where(w_rng.random(_MSLR_N_FAMILIES) < 0.4,
                            w_rng.uniform(0.6, 1.6, _MSLR_N_FAMILIES), 
                            w_rng.uniform(0.0, 0.25, _MSLR_N_FAMILIES))
    feat_sign = w_rng.choice([-1.0, 1.0], F)
    feat_kind = w_rng.integers(0, 3, F)       # 0 lognormal, 1 [0,1], 2 int
    # global label thresholds on the latent: standard-normal quantiles of
    # the cumulative WEB10K label mass
    from math import erf, sqrt
    cum = np.cumsum(_MSLR_LABEL_PROBS)[:-1]
    # invert Phi via binary search (avoid scipy)
    def _phi_inv(p):
        lo, hi = -8.0, 8.0
        for _ in range(60):
            m = (lo + hi) / 2
            if 0.5 * (1 + erf(m / sqrt(2))) < p:
                lo = m
            else:
                hi = m
        return (lo + hi) / 2
    thr = np.array([_phi_inv(p) for p in cum])

    queries = []
    for qi in range(n_queries):
        n = int(np.clip(rng.lognormal(np.log(mean_docs) - 0.32, 0.8),
                        8, 1000))
        z = rng.normal(size=n)                          # relevance latent
        labels = np.digitize(z, thr).astype(np.float32)
        fam_lat = (fam_strength[None, :] * z[:, None]
                   + rng.normal(size=(n, _MSLR_N_FAMILIES))
                   + 0.5 * rng.normal(size=(1, _MSLR_N_FAMILIES)))  # query shift
        raw = (fam_lat[:, fam_of] * feat_sign[None, :]
               + 0.35 * rng.normal(size=(n, F)))
        feats = np.empty((n, F), np.float32)
        ln = feat_kind == 0
        feats[:, ln] = np.expm1(np.clip(raw[:, ln] + 2.0, 0, 12))  # heavy tail
        un = feat_kind == 1
        feats[:, un] = 1.0 / (1.0 + np.exp(-raw[:, un]))           # [0,1]
        iq = feat_kind == 2
        feats[:, iq] = np.floor(np.clip(raw[:, iq] * 3 + 6, 0, 50))
        queries.append(Query(qid=str(qi + 1), labels=labels,
                             feats=feats.astype(np.float32),
                             descs=["" for _ in range(n)]))
    return Dataset(queries, F)
