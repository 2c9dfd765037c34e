"""Batched lambda-gradient statistics (ref: LambdaMART.computePseudoResponses,
learning/tree/LambdaMART.java:~300).

Reference semantics, per query: sort docs by current model score (desc,
stable); compute the metric swap-change matrix on that ranking; for every
ordered doc pair (i, j) with label_i > label_j:

    rho = 1 / (1 + exp(s_i − s_j))          (= sigmoid(s_j − s_i))
    lambda_i += rho·|Δ|,   lambda_j −= rho·|Δ|
    w_i += rho(1−rho)·|Δ|, w_j += rho(1−rho)·|Δ|

The reference parallelizes this over queries with MyThreadPool; here the
whole O(D²) pair block is one masked [B, D, D] elementwise program,
batched over queries. Callers (gbdt.boost, parallel.dist) hand in
padded query buckets pre-chunked so no pair temporary exceeds a fixed
element budget.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("scorer",))
def lambda_weights(scorer, labels, scores, mask):
    """Per-doc lambda and Newton weight for one padded batch.

    labels/scores: [B, D] f32; mask: [B, D] bool. Returns (lam, w) in the
    ORIGINAL doc order of the batch.
    """
    n = mask.sum(axis=-1).astype(jnp.int32)
    key = jnp.where(mask, -scores, jnp.inf)
    order = jnp.argsort(key, axis=-1, stable=True)        # score desc, pads last
    L = jnp.take_along_axis(labels, order, axis=-1)
    S = jnp.take_along_axis(scores, order, axis=-1)

    delta = jnp.abs(scorer.swap_deltas(L, n))             # [B, D, D]
    P = (L[:, :, None] > L[:, None, :]).astype(jnp.float32)
    rho = jax.nn.sigmoid(S[:, None, :] - S[:, :, None])   # sigmoid(s_j − s_i)
    m = P * rho * delta
    lam_ranked = m.sum(axis=2) - m.sum(axis=1)
    ww = P * (rho * (1.0 - rho)) * delta
    w_ranked = ww.sum(axis=2) + ww.sum(axis=1)

    inv = jnp.argsort(order, axis=-1)                     # inverse permutation
    lam = jnp.take_along_axis(lam_ranked, inv, axis=-1)
    w = jnp.take_along_axis(w_ranked, inv, axis=-1)
    z = mask.astype(jnp.float32)
    return lam * z, w * z


def chunk_scale(scorer, labels, mask):
    """[B] per-query constant factor of the swap delta for the sort-free
    path: 1/idealDCG for NDCG (labels never change during boosting, so
    the ideal ranking is computed ONCE per fit here, not once per
    round), 1 for DCG / P@k."""
    from ranklib_tpu.metrics import scorers as S

    n = mask.sum(axis=-1).astype(jnp.int32)
    if scorer.metric == "NDCG":
        ideal = S.dcg_score(S._ideal(labels, n), n, scorer.k)
        return jnp.where(ideal > 0,
                         1.0 / jnp.where(ideal > 0, ideal, 1.0), 0.0)
    return jnp.ones(labels.shape[0], jnp.float32)


def _beats(scores, mask):
    """[B, D, D] strict-ranking indicator: beats[b, i, j] = 1 iff doc j is
    ranked before doc i under stable score-desc order (score ties broken
    by original index, matching utilities/MergeSorter.java). Invalid j
    contribute 0. rank_i = Σ_j beats[i, j]."""
    D = scores.shape[-1]
    v = mask.astype(jnp.float32)
    idx = jnp.arange(D)
    si = scores[:, :, None]
    sj = scores[:, None, :]
    tie = (sj == si) & (idx[None, None, :] < idx[None, :, None])
    return ((sj > si) | tie).astype(jnp.float32) * v[:, None, :]


def _pair_lambdas(labels, scores, mask, delta):
    """Accumulate (lam, w) from a symmetric |Δ| matrix in DOC order —
    the shared tail of every sort-free lambda path."""
    v = mask.astype(jnp.float32)
    P = ((labels[:, :, None] > labels[:, None, :]).astype(jnp.float32)
         * v[:, :, None] * v[:, None, :])
    rho = jax.nn.sigmoid(scores[:, None, :] - scores[:, :, None])
    m = P * rho * delta
    lam = m.sum(axis=2) - m.sum(axis=1)
    ww = P * (rho * (1.0 - rho)) * delta
    w = ww.sum(axis=2) + ww.sum(axis=1)
    return lam * v, w * v


@functools.partial(jax.jit, static_argnames=("scorer",))
def lambda_weights_nosort_err(scorer, labels, scores, mask):
    """Sort-free lambda_weights for ERR@k — the reference's DEFAULT
    training metric (-metric2t ERR@10).

    ERR's swap delta is not product-separable (it carries the prefix
    products Π_{t<r}(1−R_t)), so the separable-path trick doesn't apply;
    instead every rank-prefix quantity of metrics/scorers.err_swap
    becomes a matvec against the beats matrix:

        rank_i = Σ_j beats[i, j]
        T_i    = Π_{j before i} (1−R_j) = exp(Σ_j beats[i, j]·log1p(−R_j))
        Elt_i  = Σ_{j before i} term_j  (term = u·R·T)

    and for a doc pair (x earlier, y later) the ranked-space closed form
    (err_swap: Δ = u_i(R_j−R_i)T_i + (ratio−1)M + u_j T_j (R_i·ratio−R_j),
    M = E_{j−1} − E_i) translates verbatim with M = Elt_y − Elt_x − term_x.
    The per-round argsort, take_alongs, and inverse permutation of the
    sorted path all disappear.

    T is computed in log-magnitude + sign-parity form: with well-formed
    data 1−R ∈ [2^−gmax, 1] and the sign factor is identically 1, but a
    label above gmax (misconfigured -gmax) makes 1−R negative — the
    sorted path's cumprod stays finite there and so must this one
    (a bare log1p would inject NaN into every lambda of the query).
    """
    from ranklib_tpu.metrics import scorers as S

    D = labels.shape[-1]
    v = mask.astype(jnp.float32)
    n = mask.sum(axis=-1).astype(jnp.int32)
    ke = S._k_eff(scorer.k, n, D).astype(jnp.float32)

    beats = _beats(scores, mask)                           # [B, D, D]
    rank = jnp.sum(beats, axis=2)                          # [B, D]
    R = ((jnp.exp2(labels) - 1.0) / (2.0 ** scorer.gmax)) * v
    one_m_R = 1.0 - R
    # clamp only the log argument: exp(-69) underflows to ~0 in f32, so a
    # (theoretically impossible for integer labels) 1−R == 0 yields T = 0
    # like the cumprod, without -inf·0 = NaN leaking through the matmul
    log_mag = jnp.log(jnp.maximum(jnp.abs(one_m_R), 1e-30))
    neg = (one_m_R < 0).astype(jnp.float32)
    # one stacked matmul instead of two: beats (the [B, D, D] block, the
    # dominant HBM read here) streams once for both prefix sums
    pre = jnp.einsum("bij,bjc->bic", beats,
                     jnp.stack([log_mag, neg], axis=-1))
    sign = 1.0 - 2.0 * jnp.mod(pre[..., 1], 2.0)
    T = sign * jnp.exp(pre[..., 0])
    ink = ((rank < ke[:, None]) & mask).astype(jnp.float32)
    u = ink / (rank + 1.0)
    term = u * R * T
    Elt = jnp.einsum("bij,bj->bi", beats, term)            # terms before i

    Rx = R[:, :, None]
    Ry = R[:, None, :]
    # sign-preserving denominator floor — formula-identical with
    # metrics.scorers.err_swap (parity-pinned); see the note there
    eps = min(1e-6, 2.0 ** (-float(scorer.gmax)) / 2.0)
    den = 1.0 - Rx
    den = jnp.where(jnp.abs(den) < eps,
                    jnp.where(den < 0, -eps, eps), den)
    ratio = (1.0 - Ry) / den
    # the clip mirrors err_swap's M = max(M, 0): a no-op for well-formed
    # data (terms are non-negative so the between-sum is too), live only
    # in the label>gmax regime — keep bit-parity with the sorted path
    M = jnp.maximum(Elt[:, None, :] - (Elt + term)[:, :, None], 0.0)
    d_el = (u[:, :, None] * (Ry - Rx) * T[:, :, None]
            + (ratio - 1.0) * M
            + u[:, None, :] * T[:, None, :] * (Rx * ratio - Ry))
    earlier = jnp.swapaxes(beats, 1, 2)                    # x before y
    dd = jnp.abs(d_el) * earlier
    delta = dd + jnp.swapaxes(dd, 1, 2)
    return _pair_lambdas(labels, scores, mask, delta)


@functools.partial(jax.jit, static_argnames=("scorer",))
def lambda_weights_nosort_map(scorer, labels, scores, mask):
    """Sort-free lambda_weights for MAP.

    Same construction as the ERR variant: MAP's cumulative relevance
    count c and harmonic prefix sum S (metrics/scorers.ap_swap) become
    beats-matrix matvecs —

        c_i = Σ_{j at-or-before i} rel_j,  S_i = Σ_{j at-or-before i} rel_j/(rank_j+1)

    — and the ranked closed form Δ = (rel_j−rel_i)(A_i − C_j + S_{j−1} − S_i)/Σrel
    maps to doc space with positions replaced by compare-count ranks.
    """
    v = mask.astype(jnp.float32)
    rel = (labels > 0).astype(jnp.float32) * v

    beats = _beats(scores, mask)
    # rank and the relevance prefix count share one pass over beats
    pre = jnp.einsum("bij,bjc->bic", beats,
                     jnp.stack([jnp.ones_like(rel), rel], axis=-1))
    rank = pre[..., 0]
    p1 = rank + 1.0
    c = pre[..., 1] + rel                                  # inclusive
    Sv = jnp.einsum("bij,bj->bi", beats, rel / p1) + rel / p1
    total = jnp.sum(rel, axis=-1)
    inv_r = jnp.where(total > 0, 1.0 / jnp.where(total > 0, total, 1.0), 0.0)

    A = (c + 1.0 - rel) / p1                               # at x (earlier)
    C = c / p1                                             # at y (later)
    between = (Sv - rel / p1)[:, None, :] - Sv[:, :, None]
    core = A[:, :, None] - C[:, None, :] + between
    d_el = (rel[:, None, :] - rel[:, :, None]) * core * inv_r[:, None, None]
    earlier = jnp.swapaxes(beats, 1, 2)
    dd = jnp.abs(d_el) * earlier
    delta = dd + jnp.swapaxes(dd, 1, 2)
    return _pair_lambdas(labels, scores, mask, delta)


@functools.partial(jax.jit, static_argnames=("scorer",))
def lambda_weights_nosort(scorer, labels, scores, mask, scale):
    """Sort-free lambda_weights for product-separable metrics
    (NDCG / DCG / P@k — the gain×discount family).

    Identical statistics to lambda_weights, but the ranked position of
    each doc is a stable compare-count (one [B, D, D] boolean reduction
    — marginal next to the pair block we pay anyway) and the position
    weight follows from the closed formula ink(rank)·1/log2(rank+2), so
    the per-round argsorts, take_alongs, and the per-round ideal re-sort
    all disappear. ``scale``: [B] from chunk_scale (per-fit constant).

    Tie-breaking parity: rank_i counts valid docs j with s_j > s_i, plus
    j < i among equal scores — exactly the stable score-desc mergesort
    position of the reference (utilities/MergeSorter.java).
    """
    from ranklib_tpu.metrics import scorers as S

    D = labels.shape[-1]
    v = mask.astype(jnp.float32)
    n = mask.sum(axis=-1).astype(jnp.int32)
    ke = S._k_eff(scorer.k, n, D)

    beats = _beats(scores, mask)
    rank = jnp.sum(beats, axis=2)                         # [B, D] f32
    ink = ((rank < ke[:, None].astype(jnp.float32)) & mask).astype(
        jnp.float32)

    if scorer.metric == "P":
        kef = ke.astype(jnp.float32)
        inv_k = jnp.where(kef > 0, 1.0 / jnp.where(kef > 0, kef, 1.0), 0.0)
        A = (labels > 0).astype(jnp.float32) * v * inv_k[:, None]
        Bv = ink
    else:                                                 # NDCG / DCG
        A = (jnp.exp2(labels) - 1.0) * v * scale[:, None]
        Bv = ink / jnp.log2(rank + 2.0)

    delta = (jnp.abs(A[:, :, None] - A[:, None, :])
             * jnp.abs(Bv[:, :, None] - Bv[:, None, :]))
    return _pair_lambdas(labels, scores, mask, delta)


# Metrics whose swap delta is PRODUCT-SEPARABLE over ranked positions,
# |Δ_ij| = |A_i − A_j|·|B_i − B_j| — the reference's gain×discount family
# (ref: metric/NDCGScorer.java:~150). They take the sort-free lambda path
# (lambda_weights_nosort); ERR/MAP have their own prefix-matvec paths.
SEPARABLE_METRICS = ("NDCG", "DCG", "P")


def separable_vectors(scorer, L, n):
    """(A, B) per-position vectors for a separable metric; L is RANKED
    labels [B, D], n true doc counts [B]. Returns None when the metric's
    swap delta is not product-separable.

    * NDCG@k: A = (2^label − 1)/idealDCG,  B = truncated 1/log2(pos+2)
    * DCG@k:  A = 2^label − 1,             B = truncated discount
    * P@k:    A = rel/k_eff,               B = inside-cutoff indicator
    """
    from ranklib_tpu.metrics import scorers as S

    if scorer.metric not in SEPARABLE_METRICS:
        return None
    D = L.shape[-1]
    valid = (jnp.arange(D)[None, :] < n[:, None]).astype(jnp.float32)
    if scorer.metric == "P":
        rel = (L > 0).astype(jnp.float32) * valid
        # k <= 0 means NO cutoff (metrics.scorers._k_eff)
        k_eff = jnp.where(jnp.int32(scorer.k) > 0,
                          jnp.minimum(jnp.int32(scorer.k), n), n)
        ke = k_eff.astype(jnp.float32)
        inv_k = jnp.where(ke > 0, 1.0 / jnp.where(ke > 0, ke, 1.0), 0.0)
        ink = S._ink(scorer.k, n, D)
        return rel * inv_k[:, None], ink
    gain = (jnp.exp2(L) - 1.0) * valid
    disc = S._ink(scorer.k, n, D) * S._discount(D)[None, :]
    if scorer.metric == "DCG":
        return gain, disc
    ideal = S.dcg_score(S._ideal(L, n), n, scorer.k)
    inv = jnp.where(ideal > 0, 1.0 / jnp.where(ideal > 0, ideal, 1.0), 0.0)
    return gain * inv[:, None], disc
