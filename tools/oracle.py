"""Independent RankLib-semantics oracle: pure numpy float64, deliberately slow.

This module is the *falsifier* for the production engine's parity claim
(the parity goal: NDCG@10 within ±0.002 of RankLib). It
re-implements the reference algorithm the way the reference describes it —
per-query nested pair loops, brute-force metric recomputation for swap
deltas, explicit per-node histograms scanned feature-major, best-first
leaf-wise growth, Newton leaf outputs, validation early-stop and best-round
rollback — and shares NO code with `ranklib_tpu` (it does not even import
it). Tests pin multi-round end-to-end agreement (tree structures, leaf
outputs, metric trajectories) between this oracle and the fused
array-shaped engine.

Reference anchors (SURVEY.md canonical paths; the mount is empty):
  * lambdas:   learning/tree/LambdaMART.java:~300 computePseudoResponses
  * histogram: learning/tree/FeatureHistogram.java:~300 findBestSplit
  * growth:    learning/tree/RegressionTree.java:~60 fit (best-first queue)
  * outputs:   learning/tree/LambdaMART.java:~400 updateTreeOutput
  * estop:     learning/tree/LambdaMART.java:~200 learn() rollback
  * metrics:   metric/{NDCG,DCG,ERR,AP,Precision}Scorer.java
  * sort ties: utilities/MergeSorter.java (stable, original index wins)

Precision contract: all statistics (gradients, histogram sums, gains,
deviances, leaf outputs, model scores) are float64. The ONE deliberate
f32 touchpoint is threshold values: the model-file format stores float32
thresholds, so candidate split values are rounded to float32 exactly like
the engine's `compute_thresholds` — otherwise a doc sitting on a grid
boundary could bin differently for reasons that are representation, not
algorithm. Everything downstream of binning is f64.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


# ---------------------------------------------------------------------------
# Metrics: direct per-ranked-list recomputation (no closed forms).


def metric_value(name: str, L, k: int, gmax: float = 4.0) -> float:
    """Metric of one ranked label list (python list / 1-D array, f64)."""
    n = len(L)
    if name == "DCG":
        return _dcg(L, k)
    if name == "NDCG":
        ideal = _dcg(sorted(L, reverse=True), k)
        return _dcg(L, k) / ideal if ideal > 0 else 0.0
    if name == "ERR":
        ke = n if k <= 0 else min(k, n)
        p, s = 1.0, 0.0
        for r in range(ke):
            R = (2.0 ** L[r] - 1.0) / (2.0 ** gmax)
            s += p * R / (r + 1)
            p *= 1.0 - R
        return s
    if name == "MAP":
        hits, s, total = 0, 0.0, sum(1 for x in L if x > 0)
        for r, x in enumerate(L):
            if x > 0:
                hits += 1
                s += hits / (r + 1)
        return s / total if total > 0 else 0.0
    if name == "P":
        ke = n if k <= 0 else min(k, n)
        hits = sum(1 for x in L[:ke] if x > 0)
        return hits / ke if ke > 0 else 0.0
    if name == "RR":
        ke = n if k <= 0 else min(k, n)
        for r in range(ke):
            if L[r] > 0:
                return 1.0 / (r + 1)
        return 0.0
    if name == "BEST":
        ke = n if k <= 0 else min(k, n)
        return max(max(L[:ke], default=0.0), 0.0) if ke > 0 else 0.0
    raise ValueError(f"unknown metric {name}")


def _dcg(L, k: int) -> float:
    n = len(L)
    ke = n if k <= 0 else min(k, n)
    return sum((2.0 ** L[r] - 1.0) / math.log2(r + 2) for r in range(ke))


def swap_delta(name: str, L, i: int, j: int, k: int,
               gmax: float = 4.0) -> float:
    """Metric change from swapping ranked positions i and j — brute force:
    swap, recompute, subtract (the reference's MetricScorer.swapChange
    contract, computed the slow honest way)."""
    base = metric_value(name, L, k, gmax)
    Ls = list(L)
    Ls[i], Ls[j] = Ls[j], Ls[i]
    return metric_value(name, Ls, k, gmax) - base


# ---------------------------------------------------------------------------
# Lambda gradients: per-query nested pair loops.


def ranked_order(scores) -> np.ndarray:
    """Stable score-descending permutation: ties broken by original index
    (MergeSorter semantics)."""
    return np.argsort(-np.asarray(scores, np.float64), kind="stable")


def lambda_gradients(labels, scores, metric: str, k: int,
                     gmax: float = 4.0):
    """(lam, w) per doc, in ORIGINAL doc order, f64.

    For every ordered pair of ranked positions (i, j) with L_i > L_j:
        rho = 1 / (1 + exp(s_i − s_j))
        lam_i += rho·|Δ|,  lam_j −= rho·|Δ|
        w_i   += rho(1−rho)·|Δ|  (and the same for j)
    """
    labels = np.asarray(labels, np.float64)
    scores = np.asarray(scores, np.float64)
    n = len(labels)
    order = ranked_order(scores)
    L = labels[order]
    S = scores[order]
    lam = np.zeros(n)
    w = np.zeros(n)
    base = metric_value(metric, list(L), k, gmax)
    for i in range(n):
        for j in range(n):
            if L[i] > L[j]:
                Ls = list(L)
                Ls[i], Ls[j] = Ls[j], Ls[i]
                delta = abs(metric_value(metric, Ls, k, gmax) - base)
                rho = 1.0 / (1.0 + math.exp(min(S[i] - S[j], 700.0)))
                lam[i] += rho * delta
                lam[j] -= rho * delta
                ww = rho * (1.0 - rho) * delta
                w[i] += ww
                w[j] += ww
    out_l = np.zeros(n)
    out_w = np.zeros(n)
    out_l[order] = lam
    out_w[order] = w
    return out_l, out_w


# ---------------------------------------------------------------------------
# Binning (thresholds stored as float32, statistics in f64).


def compute_thresholds_oracle(feats, n_threshold: int):
    """Per-feature candidate split values: all uniques when ≤ n_threshold,
    else an evenly spaced min→max grid with last point == max. Returns a
    list of 1-D float32 arrays (no padding)."""
    feats = np.asarray(feats, np.float32)
    out = []
    for f in range(feats.shape[1]):
        vals = np.unique(feats[:, f])
        if len(vals) > n_threshold:
            grid = np.linspace(float(vals[0]), float(vals[-1]),
                               n_threshold, dtype=np.float32)
            grid[-1] = vals[-1]
            vals = grid
        out.append(vals.astype(np.float32))
    return out


def bin_column(values, thresholds) -> np.ndarray:
    """Smallest b with value <= thresholds[b] (== len(thr) when above max:
    routed right forever)."""
    return np.searchsorted(thresholds, np.asarray(values, np.float32),
                           side="left").astype(np.int64)


# ---------------------------------------------------------------------------
# Regression tree: best-first leaf-wise growth, explicit histograms.


@dataclass
class OracleNode:
    docs: np.ndarray                    # int64 indices into the training set
    S: float = 0.0                      # Σ grad
    SQ: float = 0.0                     # Σ grad²
    C: float = 0.0                      # Σ count
    deviance: float = -math.inf
    best_gain: float = -math.inf
    best_f: int = -1
    best_b: int = -1
    splittable: bool = False
    # structure
    feature: int = -1
    bin: int = -1
    left: int = -1
    right: int = -1
    is_leaf: bool = True
    output: float = 0.0


@dataclass
class OracleTree:
    nodes: list                          # slot order == creation order
    thresholds: list                     # per-feature f32 arrays

    def leaf_of(self, x) -> int:
        """Traverse one raw feature vector to its leaf slot."""
        node = 0
        while not self.nodes[node].is_leaf:
            nd = self.nodes[node]
            thr = float(self.thresholds[nd.feature][nd.bin])
            node = nd.left if float(x[nd.feature]) <= thr else nd.right
        return node

    def predict(self, X) -> np.ndarray:
        return np.array([self.nodes[self.leaf_of(x)].output for x in X],
                        np.float64)


def _node_stats(docs, grad):
    g = grad[docs]
    return float(g.sum()), float((g * g).sum()), float(len(docs))


def _node_deviance(S, SQ, C):
    return SQ - S * S / C if C > 0 else -math.inf


def _best_split_oracle(docs, binned_cols, grad, mls: float,
                       feature_mask=None):
    """Scan every (feature, bin) candidate of one node feature-major;
    first strict max wins (the reference's scan order). ``feature_mask``:
    optional [F] bool — masked-out features are never split on (RF
    feature bagging, ref: RFRanker featureSamplingRate)."""
    best = (-math.inf, -1, -1)
    g = grad[docs]
    for f, col in enumerate(binned_cols):
        if feature_mask is not None and not feature_mask[f]:
            continue
        b_of_doc = col[docs]
        nb = int(b_of_doc.max()) + 1 if len(b_of_doc) else 0
        cnt = np.bincount(b_of_doc, minlength=nb).astype(np.float64)
        s = np.bincount(b_of_doc, weights=g, minlength=nb)
        c_total, s_total = cnt.sum(), s.sum()
        c_l = s_l = 0.0
        for b in range(nb):
            c_l += cnt[b]
            s_l += s[b]
            c_r = c_total - c_l
            s_r = s_total - s_l
            if c_l >= mls and c_r >= mls:
                gain = s_l * s_l / c_l + s_r * s_r / c_r
                if gain > best[0]:
                    best = (gain, f, b)
    return best + (math.isfinite(best[0]),)


def grow_tree_oracle(binned_cols, grad, n_leaves: int, mls: float,
                     thresholds, feature_mask=None) -> tuple:
    """Best-first growth to ≤ n_leaves leaves. Returns (OracleTree,
    node_of_doc, impact_per_feature).

    Queue discipline: pop the splittable leaf with maximum deviance (root
    seeded +inf so it always pops first); equal deviances break toward the
    earliest-created slot. Child nodes are appended left-then-right, so
    slot numbering matches creation order.
    """
    n = len(grad)
    F = len(binned_cols)
    all_docs = np.arange(n, dtype=np.int64)
    root = OracleNode(docs=all_docs)
    root.S, root.SQ, root.C = _node_stats(all_docs, grad)
    root.deviance = math.inf
    (root.best_gain, root.best_f, root.best_b,
     root.splittable) = _best_split_oracle(all_docs, binned_cols, grad, mls,
                                           feature_mask)
    nodes = [root]
    impacts = np.zeros(F)

    for _ in range(n_leaves - 1):
        pick, pick_dev = -1, -math.inf
        for idx, nd in enumerate(nodes):
            if nd.is_leaf and nd.splittable and nd.deviance > pick_dev:
                pick, pick_dev = idx, nd.deviance
        if pick < 0:
            break
        nd = nodes[pick]
        f, b = nd.best_f, nd.best_b
        col = binned_cols[f][nd.docs]
        left_docs = nd.docs[col <= b]
        right_docs = nd.docs[col > b]
        parent_term = nd.S * nd.S / nd.C if nd.C > 0 else 0.0
        impacts[f] += nd.best_gain - parent_term

        children = []
        for docs in (left_docs, right_docs):
            ch = OracleNode(docs=docs)
            ch.S, ch.SQ, ch.C = _node_stats(docs, grad)
            ch.deviance = _node_deviance(ch.S, ch.SQ, ch.C)
            (ch.best_gain, ch.best_f, ch.best_b,
             ch.splittable) = _best_split_oracle(docs, binned_cols, grad, mls,
                                                 feature_mask)
            children.append(ch)
        nd.feature, nd.bin = f, b
        nd.left = len(nodes)
        nd.right = len(nodes) + 1
        nd.is_leaf = False
        nodes.extend(children)

    node_of_doc = np.zeros(n, np.int64)
    for idx, nd in enumerate(nodes):
        if nd.is_leaf:
            node_of_doc[nd.docs] = idx
    return OracleTree(nodes, thresholds), node_of_doc, impacts


def set_leaf_outputs(tree: OracleTree, node_of_doc, lam, w,
                     newton: bool) -> None:
    """Newton Σλ/Σw (LambdaMART) or mean response Σλ/count (MART)."""
    for idx, nd in enumerate(tree.nodes):
        if not nd.is_leaf:
            nd.output = 0.0
            continue
        sel = node_of_doc == idx
        s1 = float(lam[sel].sum())
        s2 = float(w[sel].sum()) if newton else float(sel.sum())
        nd.output = s1 / s2 if s2 > 0 else 0.0


# ---------------------------------------------------------------------------
# The boosting loop.


@dataclass
class OracleQuery:
    labels: np.ndarray                  # [n] f64
    feats: np.ndarray                   # [n, F] f32


@dataclass
class OracleLambdaMART:
    """Reference-semantics gradient-boosted ranker.

    pointwise=False, newton=True  → LambdaMART
    pointwise=True,  newton=False → MART
    """

    n_trees: int = 50
    n_leaves: int = 10
    learning_rate: float = 0.1
    n_threshold: int = 256
    min_leaf_support: float = 1.0
    early_stop: int = 100
    estop_check_every: int = 1          # engine checks every min(estop,50)
    #   rounds in silent mode; mirror by setting this accordingly
    metric: str = "NDCG"
    k: int = 10
    gmax: float = 4.0
    pointwise: bool = False
    newton: bool = True
    trees: list = field(default_factory=list)        # kept OracleTrees
    train_metrics: list = field(default_factory=list)
    val_metrics: list = field(default_factory=list)
    impacts: np.ndarray | None = None

    # -- scoring helpers ----------------------------------------------------
    def _dataset_metric(self, queries, scores_per_q) -> float:
        total = 0.0
        for q, sc in zip(queries, scores_per_q):
            order = ranked_order(sc)
            total += metric_value(self.metric, list(q.labels[order]),
                                  self.k, self.gmax)
        return total / len(queries)

    def predict_query(self, q: OracleQuery) -> np.ndarray:
        out = np.zeros(q.feats.shape[0])
        for tree in self.trees:
            out += self.learning_rate * tree.predict(q.feats)
        return out

    # -- training -------------------------------------------------------------
    def fit(self, train: list, validation: list | None = None,
            feature_mask=None, thresholds=None) -> None:
        """train/validation: lists of OracleQuery.

        ``feature_mask``: optional [F] bool — masked features never split
        (RF feature bagging). ``thresholds``: optional per-feature f32
        threshold arrays computed elsewhere (RF bags share the full
        dataset's grid — the engine's documented global-binning design);
        default: computed from ``train`` exactly like LambdaMART.init."""
        feats = np.concatenate([q.feats for q in train], axis=0)
        labels = np.concatenate([q.labels for q in train], axis=0)
        qptr = np.cumsum([0] + [q.feats.shape[0] for q in train])
        n = feats.shape[0]
        F = feats.shape[1]
        if thresholds is None:
            thresholds = compute_thresholds_oracle(feats, self.n_threshold)
        binned_cols = [bin_column(feats[:, f], thresholds[f])
                       for f in range(F)]

        scores = np.zeros(n)
        vscores = ([np.zeros(q.feats.shape[0]) for q in validation]
                   if validation else None)
        self.trees = []
        self.train_metrics = []
        self.val_metrics = []
        self.impacts = np.zeros(F)
        all_trees = []

        for t in range(self.n_trees):
            # pseudo-responses
            if self.pointwise:
                lam = labels - scores
                w = np.ones(n)
            else:
                lam = np.zeros(n)
                w = np.zeros(n)
                for qi in range(len(train)):
                    s, e = qptr[qi], qptr[qi + 1]
                    l_, w_ = lambda_gradients(labels[s:e], scores[s:e],
                                              self.metric, self.k, self.gmax)
                    lam[s:e] = l_
                    w[s:e] = w_

            tree, node_of_doc, imp = grow_tree_oracle(
                binned_cols, lam, self.n_leaves, self.min_leaf_support,
                thresholds, feature_mask)
            set_leaf_outputs(tree, node_of_doc, lam, w, self.newton)
            self.impacts += imp
            all_trees.append(tree)
            out = np.array([tree.nodes[s].output for s in node_of_doc])
            scores = scores + self.learning_rate * out

            tm = self._dataset_metric(
                train, [scores[qptr[i]: qptr[i + 1]]
                        for i in range(len(train))])
            self.train_metrics.append(tm)

            if validation:
                for vi, q in enumerate(validation):
                    vscores[vi] = vscores[vi] + (
                        self.learning_rate * tree.predict(q.feats))
                vm = self._dataset_metric(validation, vscores)
                self.val_metrics.append(vm)
                if (self.early_stop > 0
                        and (t + 1) % max(1, self.estop_check_every) == 0):
                    best = int(np.argmax(self.val_metrics))
                    if t - best >= self.early_stop:
                        break

        keep = len(all_trees)
        if validation and self.val_metrics:
            keep = int(np.argmax(self.val_metrics)) + 1
        self.trees = all_trees[:keep]


def dataset_to_oracle(ds) -> list:
    """Adapter: a ranklib_tpu Dataset (duck-typed: .queries with .labels /
    .feats) → list[OracleQuery]. Lives here so tests don't re-write it, but
    the oracle itself never imports ranklib_tpu."""
    return [OracleQuery(labels=np.asarray(q.labels, np.float64),
                        feats=np.asarray(q.feats, np.float32))
            for q in ds.queries]


# ---------------------------------------------------------------------------
# RankBoost: explicit pair distribution, potential-matrix weak search
# (ref: learning/boosting/RankBoost.java:~30, RBWeakRanker.java).


@dataclass
class OracleRankBoost:
    """Pairwise boosting with the pair distribution D MATERIALIZED — the
    falsifier for the engine's implicit rank-1 telescoped form.

    Per round: weak ranker (f, θ) maximizing r = Σ D(x,y)(q(x) − q(y))
    over the evenly spaced threshold grid (scan order feature-major,
    thresholds ascending, strict > — first max wins); α = ½ln((1+r)/(1−r));
    D ← D·exp(α(q(y) − q(x)))/Z over (winner, loser) pairs. The reference
    precomputes exactly this candidate potential (RankBoost.java 'sweet
    spot' matrix); here it is recomputed per round from the explicit D.
    """

    n_rounds: int = 50
    n_threshold: int = 10
    metric: str = "NDCG"
    k: int = 10
    gmax: float = 4.0
    r_clip: float = 0.999999          # the engine's finite-α guard
    weaks: list = field(default_factory=list)     # (fid 1-based, θ, α)
    train_metrics: list = field(default_factory=list)
    val_metrics: list = field(default_factory=list)

    def _mean_metric(self, queries, scores_per_q) -> float:
        total = 0.0
        for q, sc in zip(queries, scores_per_q):
            order = ranked_order(sc)
            total += metric_value(self.metric, list(q.labels[order]),
                                  self.k, self.gmax)
        return total / len(queries)

    def fit(self, train: list, validation: list | None = None) -> None:
        feats = np.concatenate([q.feats for q in train], axis=0)
        labels = np.concatenate([q.labels for q in train], axis=0)
        qptr = np.cumsum([0] + [q.feats.shape[0] for q in train])
        n, F = feats.shape
        T = self.n_threshold
        lo = feats.min(axis=0).astype(np.float64)
        hi = feats.max(axis=0).astype(np.float64)
        # T evenly spaced thresholds strictly inside [lo, hi] (grid point
        # i = lo + (hi−lo)(i+1)/(T+1)); f32 like the model-file format
        grid = (lo[:, None] + (hi - lo)[:, None]
                * (np.arange(1, T + 1, dtype=np.float64)[None, :] / (T + 1))
                ).astype(np.float32)
        q_all = (feats[:, :, None].astype(np.float32)
                 > grid[None, :, :])                     # [n, F, T] bool

        pairs = []                                        # (winner, loser)
        for qi in range(len(train)):
            s, e = qptr[qi], qptr[qi + 1]
            for x in range(s, e):
                for y in range(s, e):
                    if labels[x] > labels[y]:
                        pairs.append((x, y))
        pairs = np.asarray(pairs, np.int64)
        if len(pairs) == 0:
            raise ValueError("no correctly-ordered pairs")
        D = np.full(len(pairs), 1.0 / len(pairs))
        H = np.zeros(n)
        self.weaks = []
        self.train_metrics = []
        self.val_metrics = []
        per_round_weaks = []

        for _ in range(self.n_rounds):
            # potential π(d) = Σ_{(d,y)} D − Σ_{(x,d)} D; r(f,t) = Σ π·q
            pot = np.zeros(n)
            np.add.at(pot, pairs[:, 0], D)
            np.add.at(pot, pairs[:, 1], -D)
            best_r, best_f, best_t = 0.0, -1, -1
            for f in range(F):
                for t in range(T):
                    r = float(pot @ q_all[:, f, t].astype(np.float64))
                    if r > best_r:
                        best_r, best_f, best_t = r, f, t
            if best_f < 0:                    # no candidate with r > 0
                break
            r = min(max(best_r, -self.r_clip), self.r_clip)
            alpha = 0.5 * math.log((1.0 + r) / (1.0 - r))
            qv = q_all[:, best_f, best_t].astype(np.float64)
            H = H + alpha * qv
            # explicit multiplicative update + renormalization
            D = D * np.exp(alpha * (qv[pairs[:, 1]] - qv[pairs[:, 0]]))
            D = D / D.sum()
            per_round_weaks.append(
                (best_f + 1, float(grid[best_f, best_t]), alpha))
            self.train_metrics.append(self._mean_metric(
                train, [H[qptr[i]: qptr[i + 1]] for i in range(len(train))]))
            if validation is not None:
                vsc = []
                for q in validation:
                    hv = np.zeros(q.feats.shape[0])
                    for fid, theta, a in per_round_weaks:
                        hv += a * (q.feats[:, fid - 1].astype(np.float32)
                                   > np.float32(theta))
                    vsc.append(hv)
                self.val_metrics.append(self._mean_metric(validation, vsc))

        keep = len(per_round_weaks)
        if validation is not None and self.val_metrics:
            keep = int(np.argmax(self.val_metrics)) + 1
        self.weaks = per_round_weaks[:keep]

    def predict_query(self, q) -> np.ndarray:
        out = np.zeros(q.feats.shape[0])
        for fid, theta, a in self.weaks:
            out += a * (q.feats[:, fid - 1].astype(np.float32)
                        > np.float32(theta))
        return out


# ---------------------------------------------------------------------------
# AdaRank: listwise boosting on single-feature weak rankers
# (ref: learning/boosting/AdaRank.java:~30, WeakRanker.java).


@dataclass
class OracleAdaRank:
    n_rounds: int = 50
    tolerance: float = 0.002
    no_eq: bool = False
    max_sel_count: int = 5
    metric: str = "NDCG"
    k: int = 10
    gmax: float = 4.0
    history: list = field(default_factory=list)   # kept (fid 1-based, α)
    train_metrics: list = field(default_factory=list)
    val_metrics: list = field(default_factory=list)
    weights: np.ndarray | None = None

    def _perq(self, queries, w) -> np.ndarray:
        out = np.empty(len(queries))
        for i, q in enumerate(queries):
            sc = q.feats.astype(np.float64) @ w
            order = ranked_order(sc)
            out[i] = metric_value(self.metric, list(q.labels[order]),
                                  self.k, self.gmax)
        return out

    def fit(self, train: list, validation: list | None = None) -> None:
        Q = len(train)
        F = train[0].feats.shape[1]
        # weak metric matrix S[q, f]: query q ranked by feature f alone
        S = np.empty((Q, F))
        for qi, q in enumerate(train):
            for f in range(F):
                order = ranked_order(q.feats[:, f].astype(np.float64))
                S[qi, f] = metric_value(self.metric, list(q.labels[order]),
                                        self.k, self.gmax)
        P = np.full(Q, 1.0 / Q)
        w = np.zeros(F)
        last_fid, consec = -1, 0
        prev_train = -math.inf
        self.history = []
        self.train_metrics = []
        self.val_metrics = []
        kept_vals = []

        for t in range(self.n_rounds):
            weighted = P @ S
            blocked = (self.no_eq or consec >= self.max_sel_count)
            best_f, best_v = -1, -math.inf
            for f in range(F):
                if f == last_fid and blocked:
                    continue
                if weighted[f] > best_v:
                    best_f, best_v = f, weighted[f]
            s = S[:, best_f]
            num = P @ (1.0 + s)
            den = P @ (1.0 - s)
            if num <= 0 or den <= 0:
                break                                     # degenerate
            alpha = 0.5 * math.log(num / den)
            w_new = w.copy()
            w_new[best_f] += alpha
            perq = self._perq(train, w_new)
            m_train = float(perq.mean())
            if m_train < prev_train:
                break                                     # backtrack + stop
            w = w_new
            e = np.exp(-perq)
            P = e / e.sum()
            consec = consec + 1 if best_f == last_fid else 1
            last_fid = best_f
            self.history.append((best_f + 1, alpha))
            self.train_metrics.append(m_train)
            if validation is not None:
                vm = float(self._perq(validation, w).mean())
                self.val_metrics.append(vm)
                kept_vals.append(vm)
            if t > 0 and m_train - prev_train < self.tolerance:
                prev_train = m_train
                break                                     # kept, then stop
            prev_train = m_train

        if validation is not None and kept_vals:
            best = int(np.argmax(kept_vals))
            self.history = self.history[: best + 1]
        wt = np.zeros(F)
        for fid, alpha in self.history:
            wt[fid - 1] += alpha
        self.weights = wt

    def predict_query(self, q) -> np.ndarray:
        return q.feats.astype(np.float64) @ self.weights


# ---------------------------------------------------------------------------
# Coordinate Ascent: cyclic metric line search
# (ref: learning/CoorAscent.java:~100 learn).


@dataclass
class OracleCoorAscent:
    """Independent restarts (the engine runs them in vmapped lockstep —
    semantically identical, which is exactly what this oracle falsifies).
    Restart r visits features in np.random.default_rng(seed + r)
    .permutation(F) order — the documented -randomSeed contract."""

    n_restart: int = 5
    depth: int = 25                    # geometric-ladder depth (-i)
    tolerance: float = 0.001
    reg: float | None = None
    max_passes: int = 25
    seed: int = 0
    step_base: float = 0.05
    step_scale: float = 2.0
    metric: str = "NDCG"
    k: int = 10
    gmax: float = 4.0
    weights: np.ndarray | None = None
    best_metric: float = -math.inf

    def _mean_metric(self, queries, w) -> float:
        total = 0.0
        for q in queries:
            sc = q.feats.astype(np.float64) @ w
            order = ranked_order(sc)
            total += metric_value(self.metric, list(q.labels[order]),
                                  self.k, self.gmax)
        val = total / len(queries)
        if self.reg is not None:
            val -= self.reg * float(w @ w)
        return val

    def fit(self, train: list) -> None:
        F = train[0].feats.shape[1]
        depth = max(1, self.depth)     # honor -i exactly (mirrors model)
        best_w, best_m = None, -math.inf
        for r in range(self.n_restart):
            order = np.random.default_rng(self.seed + r).permutation(F)
            w = np.full(F, 1.0 / F)
            cur = self._mean_metric(train, w)
            for _ in range(self.max_passes):
                improved = False
                for f in order:
                    base = self.step_base * max(abs(w[f]), 0.05)
                    mags = [base * self.step_scale ** d
                            for d in range(depth)]
                    deltas = mags + [-m for m in mags] + [-w[f], -2.0 * w[f]]
                    cand_best_v, cand_best_w = -math.inf, None
                    for d in deltas:
                        wc = w.copy()
                        wc[f] += d
                        norm = np.abs(wc).sum()
                        if norm <= 1e-12:
                            continue
                        wc /= norm
                        v = self._mean_metric(train, wc)
                        if v > cand_best_v:
                            cand_best_v, cand_best_w = v, wc
                    if cand_best_w is not None and (
                            cand_best_v > cur + self.tolerance):
                        w, cur = cand_best_w, cand_best_v
                        improved = True
                if not improved:
                    break
            if cur > best_m:
                best_w, best_m = w, cur
        norm = np.abs(best_w).sum()
        self.weights = best_w / (norm if norm > 0 else 1.0)
        self.best_metric = best_m

    def predict_query(self, q) -> np.ndarray:
        return q.feats.astype(np.float64) @ self.weights


# ---------------------------------------------------------------------------
# Neural rankers: tiny f64 MLP, hand-derived per-query backprop
# (ref: learning/neuralnet/{RankNet,LambdaRank,ListNet}.java).


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


@dataclass
class OracleNeuralRanker:
    """One SGD step per query (the query is the minibatch), logistic
    transfer on EVERY layer including the output. Initial parameters are
    INJECTED (list of (W [in,out], b [out]) f64 arrays) so engine and
    oracle start bit-identically; the oracle derives every gradient by
    hand (no autodiff anywhere).

    loss = 'ranknet'    Σ_{pairs i beats j} softplus(−(s_i − s_j))
           'lambdarank' the same, each pair weighted |Δmetric| of swapping
                        the pair in the CURRENT ranking (recomputed per
                        query step, brute-force swap deltas)
           'listnet'    top-one listwise CE: targets softmax(labels)
    """

    params: list
    loss: str = "ranknet"
    lr: float = 0.00005
    n_epoch: int = 5
    metric: str = "NDCG"
    k: int = 10
    gmax: float = 4.0
    val_metrics: list = field(default_factory=list)
    best_params: list | None = None
    best_val: float = -math.inf

    def _forward_cache(self, X):
        """X [n, F] → (score [n], zs, hs) with hs[0] = X."""
        hs, zs = [np.asarray(X, np.float64)], []
        h = hs[0]
        for W, b in self.params:
            z = h @ W + b
            h = _sigmoid(z)
            zs.append(z)
            hs.append(h)
        return h[:, 0], zs, hs

    def predict_query(self, q) -> np.ndarray:
        return self._forward_cache(q.feats)[0]

    def _dloss_dscore(self, s, labels) -> np.ndarray:
        n = len(s)
        g = np.zeros(n)
        if self.loss == "listnet":
            e_m = np.exp(s - s.max())
            p_model = e_m / e_m.sum()
            lab = np.asarray(labels, np.float64)
            e_t = np.exp(lab - lab.max())
            p_target = e_t / e_t.sum()
            return p_model - p_target
        if self.loss == "lambdarank":
            order = ranked_order(s)
            pos = np.empty(n, np.int64)
            pos[order] = np.arange(n)
            L_ranked = list(np.asarray(labels, np.float64)[order])
        for i in range(n):
            for j in range(n):
                if labels[i] > labels[j]:
                    rho = 1.0 / (1.0 + math.exp(min(s[i] - s[j], 700.0)))
                    wij = 1.0
                    if self.loss == "lambdarank":
                        wij = abs(swap_delta(self.metric, L_ranked,
                                             int(pos[i]), int(pos[j]),
                                             self.k, self.gmax))
                    g[i] -= rho * wij
                    g[j] += rho * wij
        return g

    def _query_step(self, q) -> None:
        s, zs, hs = self._forward_cache(q.feats)
        gs = self._dloss_dscore(s, q.labels)             # [n] dL/ds
        # backprop: s = h_last[:, 0]; σ'(z) = σ(z)(1 − σ(z)) = h(1 − h)
        delta = np.zeros_like(hs[-1])
        delta[:, 0] = gs
        grads = [None] * len(self.params)
        for li in range(len(self.params) - 1, -1, -1):
            delta = delta * hs[li + 1] * (1.0 - hs[li + 1])
            grads[li] = (hs[li].T @ delta, delta.sum(axis=0))
            if li > 0:
                delta = delta @ self.params[li][0].T
        self.params = [(W - self.lr * gW, b - self.lr * gb)
                       for (W, b), (gW, gb) in zip(self.params, grads)]

    def _mean_metric(self, queries) -> float:
        total = 0.0
        for q in queries:
            sc = self.predict_query(q)
            order = ranked_order(sc)
            total += metric_value(self.metric, list(q.labels[order]),
                                  self.k, self.gmax)
        return total / len(queries)

    def fit(self, train: list, validation: list | None = None) -> None:
        self.params = [(np.asarray(W, np.float64), np.asarray(b, np.float64))
                       for W, b in self.params]
        self.val_metrics = []
        self.best_params = [(W.copy(), b.copy()) for W, b in self.params]
        self.best_val = -math.inf
        for _ in range(self.n_epoch):
            for q in train:
                self._query_step(q)
            if validation is not None:
                vm = self._mean_metric(validation)
                self.val_metrics.append(vm)
                if vm > self.best_val:                    # strict >
                    self.best_val = vm
                    self.best_params = [(W.copy(), b.copy())
                                        for W, b in self.params]
        if validation is not None:
            self.params = self.best_params


# ---------------------------------------------------------------------------
# Linear regression: f64 normal equations with ridge
# (ref: learning/LinearRegRank.java:~25, solve :~120).


def linear_reg_oracle(train: list, lam: float = 1e-10) -> np.ndarray:
    """Return [F + 1] weights, index 0 = intercept (Gaussian elimination
    on (XᵀX + λI) w = Xᵀy — np.linalg.solve is LU, same answer in f64)."""
    feats = np.concatenate([q.feats for q in train], axis=0)
    labels = np.concatenate([q.labels for q in train], axis=0)
    X = np.concatenate([np.ones((feats.shape[0], 1)),
                        feats.astype(np.float64)], axis=1)
    xtx = X.T @ X
    xtx[np.diag_indices_from(xtx)] += lam
    return np.linalg.solve(xtx, X.T @ labels.astype(np.float64))
