"""RankBoost (`-ranker 2`).

Reference behavior (learning/boosting/RankBoost.java:~30): pairwise
boosting over all (winner, loser) doc pairs with a distribution D over
pairs (uniform init). Per round: pick the binary weak ranker
(feature f, threshold θ; q(d)=1 iff value > θ) maximizing
r = Σ D(x,y)(q(x) − q(y)); α = ½ln((1+r)/(1−r));
D ← D·exp(α(q(y)−q(x)))/Z. Final score H(d) = Σ α_t q_t(d). Candidate
thresholds: ``-tc`` (10) evenly spaced values per feature
(learning/boosting/RBWeakRanker.java).

Array shape: the pair distribution is NEVER materialized. The
reference's per-round multiplicative updates telescope to the rank-1
closed form D_t(x, y) ∝ exp(−(H(x) − H(y))) over valid (winner, loser)
pairs, where H(d) = Σ α_t q_t(d) is the strong score already carried —
so the round's pair potential π(d) = Σ_y D(d,y) − Σ_x D(x,d) and the
normalizer Z reduce to per-(query, label-level) exponential sums:
O(N·L) work (L = grade levels) instead of the O(Σ D²) of explicit
[B, D, D] pair matrices, and O(N) state instead of O(Σ D²). A per-query
midrange shift of H (which cancels exactly inside every pair product)
keeps the f32 exponentials bounded. The weak-ranker search runs through
the SAME pre-binned histogram machinery as the GBDT engine: π is
histogrammed by (feature, bin) in one segment-sum, and
r(f, θ_t) = Σ_{bins > t} hist[f, ·] is a reversed cumulative sum — no
per-candidate pass over docs.

Every round is ONE fused jitted step with donated buffers (weak pick,
α, D reweighting + global renormalization, score updates, train and
validation metrics all on device) — the host dispatches rounds
asynchronously and reads the weak-ranker arrays and metric histories
back in a single transfer after the last round, the same zero-sync
architecture as gbdt.boost (a blocking round trip per round would
otherwise add host latency to every one of 300 rounds).
"""

from __future__ import annotations

from typing import NamedTuple

import jax

import jax.numpy as jnp
import numpy as np

from ranklib_tpu.data.dataset import Dataset, flatten
from ranklib_tpu.gbdt.binning import bin_features
from ranklib_tpu.gbdt.boost import (
    _bucket_metric_sum, _device_buckets, round_capacity,
)
from ranklib_tpu.metrics.base import MetricScorer
from ranklib_tpu.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu.utils.errors import RankLibError
from ranklib_tpu.utils.logging import event, is_silent, log


def _bin_dtype(T: int):
    """Narrowest signed dtype holding bins in [0, T] (bin = #thresholds
    strictly below value, so the max is exactly T). -tc ≥ 32767 would wrap
    int16 — fall back to int32 there instead of corrupting the weak
    search (review finding, round 5)."""
    return np.int16 if T < np.iinfo(np.int16).max else np.int32


class RBData(NamedTuple):
    """Static-per-training device arrays (passed, not captured)."""

    binned_T: jnp.ndarray        # [F, N] int16/int32 (bin = #thresholds < value)
    tb: tuple                    # train buckets: ((labels, mask, didx), ...)
    uniq: jnp.ndarray            # [L] f32 sorted distinct label values —
                                 #   pair validity is label_x > label_y on
                                 #   RAW values (ref), so levels must be
                                 #   value ranks, not integer casts
    vq_T: jnp.ndarray            # [F, Nv] int16/int32 validation docs, same bins
    vb: tuple                    # validation buckets (may be empty)


class RBState(NamedTuple):
    """Donated carry: scores (which imply the pair distribution — see
    module docstring) + weak-ranker record."""

    scores: jnp.ndarray          # [N + 1] f32
    vscores: jnp.ndarray         # [Nv + 1] f32 (size 1 when no val)
    wf: jnp.ndarray              # [CAP] int32 picked feature
    wt: jnp.ndarray              # [CAP] int32 picked threshold index
    walpha: jnp.ndarray          # [CAP] f32
    wact: jnp.ndarray            # [CAP] bool (False once degenerate)
    active: jnp.ndarray          # [] bool
    train_m: jnp.ndarray         # [CAP] f32
    val_m: jnp.ndarray           # [CAP] f32


def make_rb_step(scorer, *, n_thresholds: int, n_levels: int,
                 n_queries: int, n_vqueries: int, train_metric: bool = True,
                 axis_name: str | None = None, raw: bool = False):
    """Build the jitted one-round step: (state, t, data) → state.

    ``axis_name``: set when the step runs per-device inside ``shard_map``
    (parallel/dp.py) — the pair normalizer Z, the weak-search histogram
    and the metric sums are then psum'd over that mesh axis, so every
    device takes the identical weak-ranker decision. ``raw`` returns the
    untraced body for the shard_map wrapper instead of a jitted stepper.
    """
    from ranklib_tpu.ops.histogram import hist_xla

    T = n_thresholds
    L = int(n_levels)

    def step(state: RBState, t, data: RBData) -> RBState:
        N = data.binned_T.shape[1]
        sc = state.scores

        # ---- pair potential π(d) from the implicit distribution --------
        # D(x, y) ∝ e^{−H̃(x)}·e^{H̃(y)} over (winner, loser) pairs, so
        #   π(d) = [e^{−H̃(d)}·Σ_{lab<lab(d)} e^{H̃} −
        #           e^{H̃(d)}·Σ_{lab>lab(d)} e^{−H̃}] / Z,
        #   Z    = Σ_winners e^{−H̃}·Σ_{lab below} e^{H̃}   (all pairs)
        # with level sums taken per query. H̃ = H − midrange_q(H): the
        # shift cancels inside every pair product and bounds the f32
        # exponent spread.
        pot_flat = jnp.zeros((N + 1,), jnp.float32)
        Z = jnp.float32(0.0)
        for lab, msk, didx in data.tb:
            H = sc[didx]                                       # [Bc, D]
            mf = msk.astype(jnp.float32)
            hmax = jnp.max(jnp.where(msk, H, -jnp.inf), axis=1,
                           keepdims=True)
            hmin = jnp.min(jnp.where(msk, H, jnp.inf), axis=1,
                           keepdims=True)
            c = jnp.where(jnp.isfinite(hmax), 0.5 * (hmax + hmin), 0.0)
            Ht = (H - c) * mf
            e_pos = jnp.exp(Ht) * mf
            e_neg = jnp.exp(-Ht) * mf
            # exact: lab values come verbatim from the same f32 source as
            # data.uniq, so searchsorted recovers the value's rank
            lv = jnp.clip(jnp.searchsorted(data.uniq, lab), 0, L - 1)
            oh = jax.nn.one_hot(lv, L, dtype=jnp.float32) * mf[..., None]
            S = jnp.einsum("bdl,bd->bl", oh, e_pos)            # [Bc, L]
            Tn = jnp.einsum("bdl,bd->bl", oh, e_neg)
            # exclusive prefix (levels below) / suffix (levels above)
            Wc = jnp.cumsum(S, axis=1) - S
            Lc = jnp.sum(Tn, axis=1, keepdims=True) - jnp.cumsum(Tn, axis=1)
            win = jnp.einsum("bdl,bl->bd", oh, Wc)
            lose = jnp.einsum("bdl,bl->bd", oh, Lc)
            Z += jnp.sum(e_neg * win)
            pot_flat = pot_flat.at[didx].add(e_neg * win - e_pos * lose)
        if axis_name:
            Z = jax.lax.psum(Z, axis_name)
        pot_flat = pot_flat / jnp.maximum(Z, jnp.float32(1e-30))

        # ---- weak-ranker search: histogram + reversed cumsum -----------
        # hist[f, b] = Σ_d π(d)·[bin(d, f) = b]; r(f, t) = Σ_{b > t} hist
        hist = hist_xla(data.binned_T, pot_flat[:N],
                      jnp.ones((N,), bool), T + 1)[..., 0]
        if axis_name:
            hist = jax.lax.psum(hist, axis_name)
        rev = jnp.flip(jnp.cumsum(jnp.flip(hist, axis=1), axis=1), axis=1)
        r_all = jnp.concatenate([rev[:, 1:], jnp.zeros_like(rev[:, :1])],
                                axis=1)
        flat = r_all.reshape(-1)
        idx = jnp.argmax(flat)
        f_s = (idx // (T + 1)).astype(jnp.int32)
        t_s = (idx % (T + 1)).astype(jnp.int32)
        r = jnp.clip(flat[idx], -0.999999, 0.999999)

        # t_s == T means the all-zero column won the argmax: every real
        # candidate has r ≤ 0 — no useful weak ranker. r == 0 (also when a
        # REAL column ties the zero column, e.g. Z overflowed to inf on
        # cleanly separable data) gives alpha == 0 forever after: equally a
        # no-op. Either way the round (and all later ones) deactivates and
        # the host truncates via wact.
        active = state.active & (t_s < T) & (r > 0)
        alpha = jnp.where(active, 0.5 * jnp.log((1.0 + r) / (1.0 - r)), 0.0)

        # ---- strong-model score update (implies next round's D) --------
        q_flat = (data.binned_T[f_s] > t_s).astype(jnp.float32)
        scores = state.scores.at[:-1].add(alpha * q_flat)

        # ---- metrics ----------------------------------------------------
        train_m = state.train_m
        if train_metric:
            tm = _bucket_metric_sum(scorer, data.tb, scores,
                                    axis_name) / n_queries
            train_m = train_m.at[t].set(tm)
        vscores = state.vscores
        val_m = state.val_m
        if data.vb:
            vq = (data.vq_T[f_s] > t_s).astype(jnp.float32)
            vscores = vscores.at[:-1].add(alpha * vq)
            vm = _bucket_metric_sum(scorer, data.vb, vscores,
                                    axis_name) / n_vqueries
            val_m = val_m.at[t].set(vm)

        return RBState(
            scores=scores, vscores=vscores,
            wf=state.wf.at[t].set(f_s), wt=state.wt.at[t].set(t_s),
            walpha=state.walpha.at[t].set(alpha),
            wact=state.wact.at[t].set(active),
            active=active, train_m=train_m, val_m=val_m,
        )

    if raw:
        return step
    from ranklib_tpu.gbdt.boost import _make_stepper

    return _make_stepper(step)


@register_ranker
class RankBoost(Ranker):
    NAME = "RankBoost"

    def __init__(self, **hp):
        self.n_rounds = 300
        self.n_threshold = 10
        self.weaks: list[tuple[int, float, float]] = []  # (fid, θ, α)
        super().__init__(**hp)

    def fit(self, train: Dataset, scorer: MetricScorer,
            validation: Dataset | None = None, mesh=None) -> None:
        T = int(self.n_threshold)
        if (train.queries and train.queries[0].feats is None
                and hasattr(train, "materialize_rows")):
            # CSR (-sparse): min/max + binning over bounded dense chunks;
            # the host keeps only the int16 bin matrix (~half the dense
            # f32 matrix — same discipline as the GBDT streaming loader).
            # Chunk min/max includes the materialized implicit zeros, so
            # the grid is bit-identical to the dense pipeline's.
            N, F = train.n_docs, train.n_features
            lo, hi, grid, binned = self._bin_csr_chunks(train, T)
        else:
            feats, _, _ = flatten(train)
            N, F = feats.shape
            lo = feats.min(axis=0)
            hi = feats.max(axis=0)
            # T evenly spaced candidate thresholds per feature (ref:
            # RankBoost threshold grid); constant features get an empty
            # (never-max) grid
            grid = lo[:, None] + (hi - lo)[:, None] * (
                np.arange(1, T + 1, dtype=np.float32)[None, :] / (T + 1))
            # bin = #thresholds strictly below value → q_t(d) = [bin > t]
            binned = bin_features(feats, grid)

        # initial D is uniform over correctly-ordered pairs — implied by
        # H = 0 in the implicit form; count pairs host-side only for the
        # degenerate-data check, via per-query label-value counts
        uniq = np.unique(np.concatenate(
            [q.labels.astype(np.float32) for q in train.queries]))
        n_pairs = 0
        for q in train.queries:
            _, cnt = np.unique(q.labels.astype(np.float32),
                               return_counts=True)
            below = 0
            for c in cnt:
                n_pairs += int(c) * below
                below += int(c)
        if n_pairs == 0:
            raise RankLibError("RankBoost: no correctly-ordered pairs in data")

        vbinned = None
        if validation is not None:
            if (validation.queries and validation.queries[0].feats is None
                    and hasattr(validation, "materialize_rows")):
                vbinned = self._bin_csr_chunks(validation, T, grid=grid)[3]
            else:
                vfeats, _, _ = flatten(validation)
                vbinned = bin_features(vfeats, grid)
        silent = is_silent()
        n_q = len(train.queries)
        n_vq = len(validation.queries) if validation is not None else 1
        CAP = round_capacity(self.n_rounds)
        if mesh is not None:
            data, step, state = self._build_dist(
                train, validation, scorer, mesh, binned, vbinned, uniq,
                T, n_q, n_vq, CAP, silent)
        else:
            tb = _device_buckets(train, sentinel=N)
            vb = ()
            vq_T = jnp.zeros((F, 0), jnp.int32)
            Nv = 0
            bdt = _bin_dtype(T)
            if validation is not None:
                Nv = vbinned.shape[0]
                # narrow device residency (consumers upcast on read)
                vq_T = jnp.asarray(np.ascontiguousarray(
                    vbinned.T.astype(bdt, copy=False)))
                vb = _device_buckets(validation, sentinel=Nv)

            data = RBData(
                # narrow host AND device bins — the dense path's
                # bin_features returns int32 and used to upload it as-is
                # (review finding: 2× the claimed transfer/HBM); bins are
                # ≤ T so the width follows T (-tc ≥ 32767 falls back to
                # int32 instead of silently wrapping — review finding r5)
                binned_T=jnp.asarray(np.ascontiguousarray(
                    binned.T.astype(bdt, copy=False))),
                tb=tb, uniq=jnp.asarray(uniq), vq_T=vq_T, vb=vb)
            step = make_rb_step(
                scorer, n_thresholds=T, n_levels=len(uniq),
                n_queries=n_q, n_vqueries=n_vq,
                train_metric=not silent)
            state = RBState(
                scores=jnp.zeros((N + 1,), jnp.float32),
                vscores=jnp.zeros((Nv + 1,), jnp.float32),
                wf=jnp.zeros((CAP,), jnp.int32),
                wt=jnp.zeros((CAP,), jnp.int32),
                walpha=jnp.zeros((CAP,), jnp.float32),
                wact=jnp.zeros((CAP,), bool),
                active=jnp.asarray(True),
                train_m=jnp.full((CAP,), jnp.nan, jnp.float32),
                val_m=jnp.full((CAP,), jnp.nan, jnp.float32),
            )

        log("Training starts...")
        head = f"{'#iter':<8}| {scorer.name + '-T':<11}"
        if validation is not None:
            head += f"| {scorer.name + '-V':<11}"
        log(head)
        if silent:
            from ranklib_tpu.gbdt.boost import run_silent_blocks

            state = run_silent_blocks(step, state, self.n_rounds, data)
        for t in ([] if silent else range(self.n_rounds)):
            state = step(state, t, data)
            if not bool(state.wact[t]):
                log(f"Stop at round {t + 1}: no useful weak ranker")
                break
            tm = float(state.train_m[t])
            line = f"{t + 1:<8}| {tm:<11.4f}"
            vm = None
            if validation is not None:
                vm = float(state.val_m[t])
                line += f"| {vm:<11.4f}"
            log(line)
            event("round", ranker=self.NAME, round=t + 1,
                  train_metric=tm, val_metric=vm)

        # single readback of the whole training history
        wf, wt, walpha, wact, val_m = jax.device_get(
            (state.wf, state.wt, state.walpha, state.wact, state.val_m))
        built = 0
        for t in range(self.n_rounds):
            if not wact[t]:
                break
            built = t + 1
        keep = built
        if validation is not None and built:
            keep = int(np.nanargmax(val_m[:built])) + 1
        self.weaks = [
            (int(wf[t]) + 1, float(grid[int(wf[t]), int(wt[t])]),
             float(walpha[t]))
            for t in range(keep)]

    def _build_dist(self, train, validation, scorer, mesh, binned, vbinned,
                    uniq, T, n_q, n_vq, CAP, silent):
        """Data-parallel (data, step, state) over a query-sharded mesh
        (parallel/dp.py module docstring): Z, the weak-search histogram
        and the metric sums psum; the weak pick replicates. Results are
        order-equivalent to single-device (per-device partial sums
        change f32 summation order only)."""
        from jax.sharding import PartitionSpec as P

        from ranklib_tpu.gbdt.boost_dist import AXIS, _shard_arrays
        from ranklib_tpu.parallel.dp import (
            make_dist_stepper, place_replicated, place_sharded,
        )

        n_dev = mesh.devices.size
        # int16 host/transfer discipline like the single-device path:
        # T+1 bins always fit; upcast happens ON DEVICE below
        mx = np.asarray(binned).max(initial=0)
        bdt = (np.uint8 if mx < 256
               else np.int16 if mx < np.iinfo(np.int16).max else np.int32)
        binned_T, _, _, tb, Npad = _shard_arrays(train, binned, n_dev,
                                                 bin_dtype=bdt)
        vb = ()
        Nvpad = 0
        vq_T = np.zeros((n_dev, train.n_features, 0), bdt)
        if validation is not None:
            vq_T, _, _, vb, Nvpad = _shard_arrays(validation, vbinned,
                                                  n_dev, bin_dtype=bdt)
        shd = lambda a: place_sharded(np.asarray(a), mesh)
        rep = lambda a: place_replicated(np.asarray(a), mesh)
        data = RBData(
            binned_T=shd(binned_T),
            tb=jax.tree.map(lambda a: shd(a), tb),
            uniq=rep(uniq),
            vq_T=shd(vq_T),
            vb=jax.tree.map(lambda a: shd(a), vb))
        impl = make_rb_step(
            scorer, n_thresholds=T, n_levels=len(uniq), n_queries=n_q,
            n_vqueries=n_vq, train_metric=not silent, axis_name=AXIS,
            raw=True)
        sh, rp = P(AXIS), P()
        state_specs = RBState(
            scores=sh, vscores=sh, wf=rp, wt=rp, walpha=rp, wact=rp,
            active=rp, train_m=rp, val_m=rp)
        data_specs = RBData(
            binned_T=sh, tb=jax.tree.map(lambda _: sh, tb), uniq=rp,
            vq_T=sh, vb=jax.tree.map(lambda _: sh, vb))
        step = make_dist_stepper(impl, mesh, state_specs, (data_specs,))
        state = RBState(
            scores=shd(np.zeros((n_dev, Npad + 1), np.float32)),
            vscores=shd(np.zeros((n_dev, Nvpad + 1), np.float32)),
            wf=rep(np.zeros((CAP,), np.int32)),
            wt=rep(np.zeros((CAP,), np.int32)),
            walpha=rep(np.zeros((CAP,), np.float32)),
            wact=rep(np.zeros((CAP,), bool)),
            active=rep(np.asarray(True)),
            train_m=rep(np.full((CAP,), np.nan, np.float32)),
            val_m=rep(np.full((CAP,), np.nan, np.float32)),
        )
        return data, step, state

    @staticmethod
    def _bin_csr_chunks(ds, T: int, grid: np.ndarray | None = None):
        """(lo, hi, grid, binned int16) from a CSRDataset in bounded
        dense chunks. Two passes: chunked min/max over MATERIALIZED rows
        (implicit zeros included — identical to the dense pipeline's
        feats.min/max), then chunked binning into the int16 matrix.
        ``grid``: reuse an existing grid (validation bins with the
        training grid)."""
        from ranklib_tpu.data.sparse import _chunk_bytes

        N, F = ds.n_docs, ds.n_features
        rows = max(1, _chunk_bytes() // (F * 4))
        lo = hi = None
        if grid is None:
            lo = np.full(F, np.inf, np.float32)
            hi = np.full(F, -np.inf, np.float32)
            for s in range(0, N, rows):
                X = ds.materialize_rows(s, min(s + rows, N))
                np.minimum(lo, X.min(axis=0), out=lo)
                np.maximum(hi, X.max(axis=0), out=hi)
            grid = lo[:, None] + (hi - lo)[:, None] * (
                np.arange(1, T + 1, dtype=np.float32)[None, :] / (T + 1))
        bdt = _bin_dtype(T)
        binned = np.empty((N, F), bdt)
        for s in range(0, N, rows):
            e = min(s + rows, N)
            binned[s:e] = bin_features(ds.materialize_rows(s, e),
                                       grid).astype(bdt)
        return lo, hi, grid, binned

    # ---- scoring ---------------------------------------------------------
    def eval_dataset(self, ds: Dataset):
        from ranklib_tpu.data.dataset import query_feats

        if not self.weaks:
            raise RankLibError("Model not trained/loaded")
        F = ds.n_features
        fids = np.array([min(w[0] - 1, F - 1) for w in self.weaks])
        inrange = np.array([w[0] <= F for w in self.weaks], np.float32)
        thetas = np.array([w[1] for w in self.weaks], np.float32)
        alphas = np.array([w[2] for w in self.weaks], np.float32) * inrange
        # H(d) = Σ_t α_t · [v_{f_t}(d) > θ_t] — one gather + one matvec
        return [
            ((query_feats(ds, qi)[:, fids] > thetas[None, :])
             .astype(np.float32) @ alphas).astype(np.float32)
            for qi in range(len(ds.queries))]

    # ---- serialization -----------------------------------------------------
    def model_str(self) -> str:
        head = model_header(self.NAME, {
            "Iteration": self.n_rounds,
            "No. of threshold candidates": self.n_threshold,
        })
        body = "\n".join(f"{fid}:{theta}:{alpha}"
                         for fid, theta, alpha in self.weaks)
        return head + body + "\n"

    def load_str(self, text: str) -> None:
        _, body = parse_model_params(text)
        self.weaks = []
        for line in body:
            for tok in line.split():
                fid, theta, alpha = tok.split(":")
                self.weaks.append((int(fid), float(theta), float(alpha)))
        if not self.weaks:
            raise RankLibError("Empty RankBoost model body")
