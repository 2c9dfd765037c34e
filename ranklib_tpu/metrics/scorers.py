"""All ranking metrics as pure masked jnp functions, with closed-form
swap-delta matrices.

Reference behavior (SURVEY.md §2 L2b; ref: metric/*Scorer.java):

* every scorer works on one ranked list; ``score_all`` macro-averages over
  queries;
* ``swap_deltas`` returns the [D, D] matrix of metric changes caused by
  swapping ranked positions i and j — the hook LambdaMART / LambdaRank /
  AdaRank train through (ref: metric/MetricScorer.java:~60);
* NDCG/DCG: gain 2^label − 1, discount 1/log2(pos+2), truncated at k;
  ideal DCG of 0 → score 0 (ref: metric/NDCGScorer.java:~20);
* ERR: R(l) = (2^l − 1)/2^gmax, ERR@k = Σ_{r≤k} (1/r)·R_r·Π_{t<r}(1−R_t)
  (ref: metric/ERRScorer.java:~15, MAX set by -gmax, default 4);
* MAP: binary rel = label>0, AP over ALL retrieved docs, no k truncation
  (ref: metric/APScorer.java:~15);
* P@k, RR@k, Best@k per metric/{Precision,ReciprocalRank,BestAtK}Scorer.

All functions take ranked labels L[B, D] (padding zeros at the tail) and
true doc counts n[B]; everything is jit/vmap/grad-safe with static shapes.
Swap-delta matrices are exact closed forms — no O(D³) recomputation — so
they batch as [B, D, D] elementwise work.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_BIG = jnp.inf


def _pos(D):
    return jnp.arange(D, dtype=jnp.float32)


def _k_eff(k: int, n, D):
    """Effective cutoff per query: min(k, n), or n when k <= 0."""
    n = n.astype(jnp.int32)
    if k is None or k <= 0:
        return n
    return jnp.minimum(jnp.int32(k), n)


def _ink(k: int, n, D):
    """[B, D] float mask of positions inside the cutoff."""
    ke = _k_eff(k, n, D)
    return (jnp.arange(D)[None, :] < ke[:, None]).astype(jnp.float32)


def _valid(n, D):
    return (jnp.arange(D)[None, :] < n.astype(jnp.int32)[:, None]).astype(jnp.float32)


def _pair_valid(n, D):
    v = _valid(n, D)
    return v[:, :, None] * v[:, None, :]


def _gain(L):
    return jnp.exp2(L) - 1.0


def _discount(D):
    return 1.0 / jnp.log2(_pos(D) + 2.0)


def _ideal(L, n):
    """Labels sorted descending over valid positions (stable)."""
    D = L.shape[-1]
    key = jnp.where(_valid(n, D) > 0, -L, _BIG)
    order = jnp.argsort(key, axis=-1, stable=True)
    return jnp.take_along_axis(L, order, axis=-1) * _valid(n, D)


def _sym(upper):
    """Mirror an upper-triangular [B, D, D] into a symmetric matrix."""
    D = upper.shape[-1]
    i = jnp.arange(D)
    ut = (i[:, None] < i[None, :]).astype(upper.dtype)
    u = upper * ut
    return u + jnp.swapaxes(u, -1, -2)


# ----------------------------------------------------------------------------
# DCG / NDCG


def dcg_score(L, n, k):
    D = L.shape[-1]
    w = _ink(k, n, D) * _discount(D)[None, :]
    return jnp.sum(_gain(L) * w * _valid(n, D), axis=-1)


def dcg_swap(L, n, k):
    D = L.shape[-1]
    g = _gain(L) * _valid(n, D)
    w = _ink(k, n, D) * _discount(D)[None, :]
    # swap(i,j): Δ = (g_i − g_j)(w_j − w_i); symmetric by construction
    dg = g[:, :, None] - g[:, None, :]
    dw = w[:, None, :] - w[:, :, None]
    return dg * dw * _pair_valid(n, D)


def ndcg_score(L, n, k):
    ideal = dcg_score(_ideal(L, n), n, k)
    return jnp.where(ideal > 0, dcg_score(L, n, k) / jnp.where(ideal > 0, ideal, 1.0), 0.0)


def ndcg_swap(L, n, k):
    ideal = dcg_score(_ideal(L, n), n, k)
    scale = jnp.where(ideal > 0, 1.0 / jnp.where(ideal > 0, ideal, 1.0), 0.0)
    return dcg_swap(L, n, k) * scale[:, None, None]


# ----------------------------------------------------------------------------
# ERR


def _err_parts(L, n, k, gmax):
    D = L.shape[-1]
    v = _valid(n, D)
    R = (_gain(L) / (2.0 ** gmax)) * v                      # stopping prob
    # exclusive cumulative product Π_{t<p}(1 − R_t)
    T = jnp.concatenate([jnp.ones_like(R[:, :1]),
                         jnp.cumprod(1.0 - R[:, :-1], axis=-1)], axis=-1)
    u = _ink(k, n, D) / (_pos(D)[None, :] + 1.0)            # truncated 1/rank
    term = u * R * T
    return R, T, u, term


def err_score(L, n, k, gmax=4.0):
    _, _, _, term = _err_parts(L, n, k, gmax)
    return jnp.sum(term, axis=-1)


def err_swap(L, n, k, gmax=4.0):
    D = L.shape[-1]
    R, T, u, term = _err_parts(L, n, k, gmax)
    E = jnp.cumsum(term, axis=-1)
    # M[i, j] = Σ_{i<p<j} term_p  =  E_{j-1} − E_i   (0 when j <= i+1)
    Ej1 = jnp.concatenate([jnp.zeros_like(E[:, :1]), E[:, :-1]], axis=-1)
    M = Ej1[:, None, :] - E[:, :, None]
    M = jnp.maximum(M, 0.0)
    # (1−R_j)/(1−R_i), with a sign-preserving floor on the denominator:
    # R_i == 1 exactly (reachable only with labels ABOVE -gmax, e.g.
    # binary labels under -gmax 0) made this 0/0 → NaN lambdas from
    # round one (review finding, round 5). The floor is exact for
    # well-formed data (1−R ≥ 2^−gmax ≫ 1e-6); at the boundary the
    # NaN-producing terms carry an exact 0 factor (T/M vanish with
    # 1−R_i), so any finite ratio yields the correct 0 contribution.
    # MUST stay formula-identical with gbdt.lambdas' nosort ERR path
    # (parity-pinned).
    # floor scaled to the label range: legitimate 1−R is ≥ 2^−gmax, so
    # min(1e-6, 2^−gmax/2) never perturbs a valid ratio even at
    # -gmax ≥ 20 (a fixed 1e-6 floor did — follow-up review finding)
    eps = min(1e-6, 2.0 ** (-float(gmax)) / 2.0)
    den = 1.0 - R[:, :, None]
    den = jnp.where(jnp.abs(den) < eps,
                    jnp.where(den < 0, -eps, eps), den)
    ratio = (1.0 - R[:, None, :]) / den
    dij = (
        u[:, :, None] * (R[:, None, :] - R[:, :, None]) * T[:, :, None]
        + (ratio - 1.0) * M
        + u[:, None, :] * T[:, None, :] * (R[:, :, None] * ratio - R[:, None, :])
    )
    return _sym(dij) * _pair_valid(n, D)


# ----------------------------------------------------------------------------
# MAP (AP per query)


def ap_score(L, n, k=None):
    D = L.shape[-1]
    v = _valid(n, D)
    rel = (L > 0).astype(jnp.float32) * v
    c = jnp.cumsum(rel, axis=-1)
    total = jnp.sum(rel, axis=-1)
    ap = jnp.sum(rel * c / (_pos(D)[None, :] + 1.0), axis=-1)
    return jnp.where(total > 0, ap / jnp.where(total > 0, total, 1.0), 0.0)


def ap_swap(L, n, k=None):
    D = L.shape[-1]
    v = _valid(n, D)
    rel = (L > 0).astype(jnp.float32) * v
    c = jnp.cumsum(rel, axis=-1)
    total = jnp.sum(rel, axis=-1)
    inv_r = jnp.where(total > 0, 1.0 / jnp.where(total > 0, total, 1.0), 0.0)
    p1 = _pos(D)[None, :] + 1.0
    S = jnp.cumsum(rel / p1, axis=-1)
    # For i<j: Δ·R = (rel_j − rel_i)·[ (c_i + 1 − rel_i)/(i+1) − c_j/(j+1)
    #                                  + (S_{j−1} − S_i) ]
    A = (c + 1.0 - rel) / p1
    C = c / p1
    Sj1 = jnp.concatenate([jnp.zeros_like(S[:, :1]), S[:, :-1]], axis=-1)
    between = Sj1[:, None, :] - S[:, :, None]
    core = A[:, :, None] - C[:, None, :] + between
    drel = rel[:, None, :] - rel[:, :, None]                # rel_j − rel_i
    dij = drel * core * inv_r[:, None, None]
    return _sym(dij) * _pair_valid(n, D)


# ----------------------------------------------------------------------------
# Precision@k


def precision_score(L, n, k):
    D = L.shape[-1]
    rel = (L > 0).astype(jnp.float32) * _valid(n, D)
    ke = _k_eff(k, n, D).astype(jnp.float32)
    hits = jnp.sum(rel * _ink(k, n, D), axis=-1)
    return jnp.where(ke > 0, hits / jnp.where(ke > 0, ke, 1.0), 0.0)


def precision_swap(L, n, k):
    D = L.shape[-1]
    rel = (L > 0).astype(jnp.float32) * _valid(n, D)
    ink = _ink(k, n, D)
    ke = _k_eff(k, n, D).astype(jnp.float32)
    inv_k = jnp.where(ke > 0, 1.0 / jnp.where(ke > 0, ke, 1.0), 0.0)
    drel = rel[:, None, :] - rel[:, :, None]
    dink = ink[:, :, None] - ink[:, None, :]
    return drel * dink * inv_k[:, None, None] * _pair_valid(n, D)


# ----------------------------------------------------------------------------
# Reciprocal rank @k


def _first_rel(L, n, k):
    D = L.shape[-1]
    rel = (L > 0) & (_ink(k, n, D) > 0)
    idx = jnp.where(rel, jnp.arange(D)[None, :].astype(jnp.float32), _BIG)
    return jnp.min(idx, axis=-1)  # inf when none


def rr_score(L, n, k):
    f = _first_rel(L, n, k)
    return jnp.where(jnp.isfinite(f), 1.0 / (f + 1.0), 0.0)


def rr_swap(L, n, k):
    """Closed-form RR swap via first-relevant-position case analysis."""
    D = L.shape[-1]
    v = _valid(n, D)
    ink = _ink(k, n, D)
    rel = (L > 0).astype(jnp.float32) * v
    f = _first_rel(L, n, k)                                  # [B]
    old = jnp.where(jnp.isfinite(f), 1.0 / (f + 1.0), 0.0)   # [B]
    pos = jnp.arange(D, dtype=jnp.float32)

    # next relevant strictly after p (within cutoff); inf when none
    idx = jnp.where((rel > 0) & (ink > 0), pos[None, :], _BIG)
    rev_cummin = jnp.flip(lax.cummin(jnp.flip(idx, axis=-1), axis=idx.ndim - 1),
                          axis=-1)
    nxt = jnp.concatenate([rev_cummin[:, 1:], jnp.full_like(rev_cummin[:, :1], _BIG)],
                          axis=-1)                           # [B, D]

    ri = rel[:, :, None]
    rj = rel[:, None, :]
    pi = pos[None, :, None] * jnp.ones((1, 1, D))
    pj = pos[None, None, :] * jnp.ones((1, D, 1))
    ink_i = ink[:, :, None]
    ink_j = ink[:, None, :]
    fB = f[:, None, None]

    # promote: rel_i=0, rel_j=1 → new first = min(f, i) if i inside cutoff
    f_promote = jnp.where(ink_i > 0, jnp.minimum(fB, pi), fB)
    # demote: rel_i=1, rel_j=0 → only changes when i was the first rel;
    # new first = min(next-rel-after-i, j if j inside cutoff)
    nxt_i = nxt[:, :, None] * jnp.ones((1, 1, D))
    j_cand = jnp.where(ink_j > 0, pj, _BIG)
    f_demote = jnp.where((ink_i > 0) & (fB == pi), jnp.minimum(nxt_i, j_cand), fB)

    f_new = jnp.where((ri < 0.5) & (rj > 0.5), f_promote,
                      jnp.where((ri > 0.5) & (rj < 0.5), f_demote, fB))
    new = jnp.where(jnp.isfinite(f_new), 1.0 / (f_new + 1.0), 0.0)
    dij = new - old[:, None, None]
    # build upper triangle (i<j) then mirror — the case analysis assumed i<j
    return _sym(dij) * _pair_valid(n, D)


# ----------------------------------------------------------------------------
# Best@k (max label within the top k, ref: metric/BestAtKScorer.java)


def best_score(L, n, k):
    D = L.shape[-1]
    ink = _ink(k, n, D)
    return jnp.max(jnp.where(ink > 0, L, -_BIG), axis=-1).clip(min=0.0) * (
        _k_eff(k, n, D) > 0
    )


def best_swap(L, n, k):
    D = L.shape[-1]
    ink = _ink(k, n, D)
    Lin = jnp.where(ink > 0, L, -_BIG)
    m1 = jnp.max(Lin, axis=-1)                                # top-k max
    cnt1 = jnp.sum((Lin == m1[:, None]).astype(jnp.float32), axis=-1)
    L2 = jnp.where(Lin == m1[:, None], -_BIG, Lin)
    m2 = jnp.max(L2, axis=-1)                                 # second value
    # dropping position i from top-k: max stays m1 unless i is the unique max
    drop_max = jnp.where((Lin == m1[:, None]) & (cnt1[:, None] <= 1),
                         m2[:, None], m1[:, None])            # [B, D]
    # only cross-boundary swaps (i inside k, j outside) change the set.
    # where(), not multiply-by-zero: a fully-padded row (n = 0) has
    # m1 = max(all −inf) = −inf, and (−inf − −inf)·0 = NaN — every other
    # swap_fn returns exact 0 for that row and batched pad-row consumers
    # rely on it (review finding, round 5)
    cross = ink[:, :, None] * (1.0 - ink[:, None, :])
    new_max = jnp.maximum(drop_max[:, :, None], L[:, None, :])
    dij = jnp.where(cross > 0, new_max - m1[:, None, None], 0.0)
    return _sym(dij) * _pair_valid(n, D)
