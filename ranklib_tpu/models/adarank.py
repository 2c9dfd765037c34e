"""AdaRank (`-ranker 3`).

Reference behavior (learning/boosting/AdaRank.java:~30): listwise boosting
whose weak rankers are single features (rank docs by one feature value,
descending). Per round, with per-query weights P(q) (uniform init):

* pick the feature maximizing Σ_q P(q)·metric(q ranked by feature);
* α = ½ ln(Σ P(1+s) / Σ P(1−s)) with s the per-query weak metric;
* the strong ranker is H(d) = Σ α_t·feature_{f_t}(d) — linear in features;
* P ← exp(−metric(q, H)) / Z;
* guards: ``-noeq`` forbids immediate reselection, ``-max`` (5) caps
  consecutive picks of one feature, ``-tolerance`` (0.002) stops when the
  train metric stalls, and the round is rolled back if the train metric
  drops.

Array shape: ranking every query by every feature never changes, so the
per-(query, feature) weak-metric matrix S[Q, F] is computed ONCE with the
batched candidate evaluator (feats @ I — one matmul per bucket).
Every round is then ONE fused jitted step with donated state: feature
pick (with the noeq/consec guards as masking), α, the strong-model
per-query metric (for both the console table and the P reweighting),
validation metric, and all stop/backtrack conditions evaluated on device
as an active flag — the host dispatches rounds asynchronously and reads
the whole history back in a single transfer (same zero-sync architecture
as gbdt.boost).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ranklib_tpu.data.dataset import Dataset
from ranklib_tpu.gbdt.boost import round_capacity
from ranklib_tpu.metrics.base import MetricScorer
from ranklib_tpu.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu.ops.batched_eval import LinearMetricEvaluator
from ranklib_tpu.utils.errors import RankLibError
from ranklib_tpu.utils.logging import event, is_silent, log


class AdaState(NamedTuple):
    """Donated carry of the fused AdaRank round step."""

    P: jnp.ndarray               # [Q] query weights
    w: jnp.ndarray               # [F] accumulated α per feature
    last_fid: jnp.ndarray        # [] int32 (-1 initially)
    consec: jnp.ndarray          # [] int32 consecutive picks of last_fid
    prev_train: jnp.ndarray      # [] f32
    active: jnp.ndarray          # [] bool
    hfid: jnp.ndarray            # [CAP] int32 picked feature per round
    halpha: jnp.ndarray          # [CAP] f32
    hact: jnp.ndarray            # [CAP] bool round kept
    train_m: jnp.ndarray         # [CAP] f32
    val_m: jnp.ndarray           # [CAP] f32


def make_ada_step(scorer, *, no_eq: bool, max_sel: int, tolerance: float,
                  n_queries: int, n_vqueries: int, n_vslots: int | None = None,
                  axis_name: str | None = None, raw: bool = False,
                  sparse_docs: tuple | None = None):
    """Build the jitted one-round step: (state, t, S, tb, vb, qmask) →
    state.

    ``tb``/``vb``: tuples of (feats, labels, mask, qidx) device buckets;
    qidx scatters per-query metrics back to P's slot order (Dataset order
    single-device; device-local slots under DP). ``qmask``: [slots] bool,
    True for real queries (padding slots exist only under DP).

    ``axis_name``: set when the step runs per-device inside ``shard_map``
    (parallel/dp.py) — P·S, the α numerator/denominator, the reweighting
    normalizer and the metric sums psum over that axis, so the feature
    pick and all stop/backtrack decisions replicate. ``raw`` returns the
    untraced body for the shard_map wrapper. ``n_vslots``: validation
    slot count (defaults to n_vqueries — the single-device layout).

    ``sparse_docs``: (n_train_docs, n_val_docs) when ``tb``/``vb`` carry
    the sparse-score layout instead of dense feature buckets: each is
    ``(coo_chunks, (labels, mask, didx, qidx) buckets)`` — the strong
    model scores through the gather/segment-sum layer
    (ops.sparse_eval), so wide data needs no dense [B, D, F] blocks in
    HBM.
    """
    n_vslots = n_vqueries if n_vslots is None else n_vslots

    def _psum(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    def _perq_and_mean(wvec, buckets, n_slots, nq, n_docs=None):
        """Per-query metric of the linear model wvec, scattered to slot
        order ([n_slots]); padded chunk rows carry sentinel qidx =
        n_slots. The mean divides the (psum'd) sum by the GLOBAL query
        count nq."""
        perq = jnp.zeros((n_slots + 1,), jnp.float32)
        if sparse_docs is not None:
            from ranklib_tpu.ops.sparse_eval import sparse_scores_flat

            chunks, bks = buckets
            Sf = sparse_scores_flat(wvec[:, None], chunks, n_docs)[:, 0]
            for labels, mask, didx, qidx in bks:
                vals = scorer.score_from_scores(labels, Sf[didx], mask)
                perq = perq.at[qidx].set(vals)
            perq = perq[:-1]
            return perq, _psum(perq.sum()) / nq
        for feats, labels, mask, qidx in buckets:
            sc = jnp.einsum("bdf,f->bd", feats, wvec,
                            preferred_element_type=jnp.float32)
            vals = scorer.score_from_scores(labels, sc, mask)
            perq = perq.at[qidx].set(vals)
        perq = perq[:-1]
        return perq, _psum(perq.sum()) / nq

    def step(state: AdaState, t, S, tb, vb, qmask) -> AdaState:
        F = state.w.shape[0]
        n_slots = qmask.shape[0]
        weighted = _psum(state.P @ S)                  # [F]
        # noeq / consecutive-pick guard: mask the last feature out
        blocked = (jnp.arange(F) == state.last_fid) & (
            jnp.bool_(no_eq) | (state.consec >= max_sel))
        fid = jnp.argmax(jnp.where(blocked, -jnp.inf, weighted))
        s = S[:, fid]
        num = _psum(state.P @ (1.0 + s))
        den = _psum(state.P @ (1.0 - s))
        degenerate = (num <= 0) | (den <= 0)
        alpha = 0.5 * jnp.log(jnp.where(degenerate, 1.0, num / den))
        w_new = state.w.at[fid].add(alpha)

        perq, m_train = _perq_and_mean(
            w_new, tb, n_slots, n_queries,
            n_docs=sparse_docs[0] if sparse_docs is not None else None)
        backtrack = m_train < state.prev_train
        keep = state.active & ~degenerate & ~backtrack

        w = jnp.where(keep, w_new, state.w)
        e = jnp.where(qmask, jnp.exp(-perq), 0.0)
        P = jnp.where(keep, e / _psum(e.sum()), state.P)
        last_fid = jnp.where(keep, fid.astype(jnp.int32), state.last_fid)
        consec = jnp.where(
            keep,
            jnp.where(fid.astype(jnp.int32) == state.last_fid,
                      state.consec + 1, 1),
            state.consec)
        # tolerance stop: the round is KEPT, later rounds become no-ops
        tol_stop = keep & (m_train - state.prev_train < tolerance) & (t > 0)
        active = keep & ~tol_stop
        prev_train = jnp.where(keep, m_train, state.prev_train)

        val_m = state.val_m
        if vb:
            _, vm = _perq_and_mean(
                w, vb, n_vslots, n_vqueries,
                n_docs=sparse_docs[1] if sparse_docs is not None else None)
            val_m = val_m.at[t].set(vm)

        return AdaState(
            P=P, w=w, last_fid=last_fid, consec=consec,
            prev_train=prev_train, active=active,
            hfid=state.hfid.at[t].set(fid.astype(jnp.int32)),
            halpha=state.halpha.at[t].set(alpha),
            hact=state.hact.at[t].set(keep),
            train_m=state.train_m.at[t].set(m_train),
            val_m=val_m,
        )

    if raw:
        return step
    from ranklib_tpu.gbdt.boost import _make_stepper

    return _make_stepper(step)


def _device_buckets_q(ds, sentinel_doc: int, sentinel_q: int) -> tuple:
    """(labels, mask, didx, qidx) chunks — gbdt.boost._device_buckets
    with the qidx channel, for scattering per-query metrics from flat
    sparse scores."""
    from ranklib_tpu.gbdt.boost import _device_buckets

    return _device_buckets(ds, sentinel_doc, qidx_sentinel=sentinel_q)


@register_ranker
class AdaRank(Ranker):
    NAME = "AdaRank"

    def __init__(self, **hp):
        self.n_rounds = 500
        self.tolerance = 0.002
        self.no_eq = False           # -noeq: never reselect the last feature
        self.max_sel_count = 5       # consecutive-pick cap otherwise
        self.weights = None          # np.float64 [F] accumulated α per fid
        self.history: list[tuple[int, float]] = []   # (fid, α) per round
        super().__init__(**hp)

    def fit(self, train: Dataset, scorer: MetricScorer,
            validation: Dataset | None = None, mesh=None) -> None:
        from ranklib_tpu.ops.sparse_eval import wants_sparse_eval

        F = train.n_features
        Q = len(train.queries)
        n_vq = len(validation.queries) if validation is not None else 1
        CAP = round_capacity(self.n_rounds)
        sparse_mode = wants_sparse_eval(train)
        if sparse_mode and mesh is not None:
            # -sparse -dp cross product (round-5): S rows + COO chunks +
            # buckets shard over the mesh; the step's psum'd sums make
            # every pick/α/stop decision identical to single-device
            return self._fit_sparse_dist(train, validation, scorer, mesh,
                                         F, Q, n_vq, CAP)
        if sparse_mode:
            # wide CSR: S built sparsely (absent features reuse the
            # query's zero-score metric — ops.sparse_eval), strong-model
            # scoring through the gather/segment-sum layer. The dense
            # evaluator's feats@eye(F) needs [N, F] + [F, F] in HBM.
            from ranklib_tpu.ops.sparse_eval import (
                adarank_weak_matrix, build_sparse_data,
            )

            S_np = adarank_weak_matrix(train, scorer)
            chunks, _, Ntr = build_sparse_data(train)
            tb = (chunks, _device_buckets_q(train, Ntr, Q))
            vb = ()
            Nv = 1
            if validation is not None:
                vchunks, _, Nv = build_sparse_data(validation)
                vb = (vchunks, _device_buckets_q(validation, Nv, n_vq))
            S = jnp.asarray(S_np)
            qmask = jnp.ones((Q,), bool)
            step = make_ada_step(
                scorer, no_eq=self.no_eq, max_sel=self.max_sel_count,
                tolerance=self.tolerance, n_queries=Q, n_vqueries=n_vq,
                sparse_docs=(Ntr, Nv))
            state = self._init_state(Q, F, CAP)
            return self._run_rounds(step, state, S, tb, vb, qmask,
                                    validation, scorer)
        ev = LinearMetricEvaluator(train, scorer)
        # S[q, f]: metric of query q ranked by feature f alone — one batched
        # candidate pass (feats @ I), computed once
        S_np = ev.per_query_matrix(np.eye(F, dtype=np.float32)).astype(
            np.float32)
        if mesh is not None:
            # free the evaluator's dense device buckets BEFORE the dist
            # build uploads the sharded copy of the same features — the
            # -dp case is exactly when memory is tight (review finding)
            del ev
            S, tb, vb, qmask, step, state = self._build_dist(
                train, validation, scorer, mesh, S_np, Q, n_vq, CAP)
        else:
            S = jnp.asarray(S_np)

            def _device_qidx(evaluator, nq):
                out = []
                for f, l, m, q in evaluator.buckets:
                    qpad = np.full(f.shape[0], nq, np.int32)  # sentinel
                    qpad[: len(q)] = q
                    out.append((f, l, m, jnp.asarray(qpad)))
                return tuple(out)

            tb = _device_qidx(ev, Q)
            vb = ()
            if validation is not None:
                vev = LinearMetricEvaluator(validation, scorer)
                vb = _device_qidx(vev, n_vq)
            qmask = jnp.ones((Q,), bool)

            step = make_ada_step(
                scorer, no_eq=self.no_eq, max_sel=self.max_sel_count,
                tolerance=self.tolerance, n_queries=Q, n_vqueries=n_vq)
            state = self._init_state(Q, F, CAP)

        return self._run_rounds(step, state, S, tb, vb, qmask, validation,
                                scorer)

    @staticmethod
    def _init_state(Q: int, F: int, CAP: int) -> AdaState:
        return AdaState(
            P=jnp.full((Q,), 1.0 / Q, jnp.float32),
            w=jnp.zeros((F,), jnp.float32),
            last_fid=jnp.int32(-1), consec=jnp.int32(0),
            prev_train=jnp.float32(-np.inf), active=jnp.asarray(True),
            hfid=jnp.zeros((CAP,), jnp.int32),
            halpha=jnp.zeros((CAP,), jnp.float32),
            hact=jnp.zeros((CAP,), bool),
            train_m=jnp.full((CAP,), jnp.nan, jnp.float32),
            val_m=jnp.full((CAP,), jnp.nan, jnp.float32),
        )

    def _run_rounds(self, step, state, S, tb, vb, qmask, validation,
                    scorer) -> None:
        """Shared round loop + readback (single-device, DP, and the
        wide-sparse score layout all use the same stepper contract)."""
        F = S.shape[-1]
        log("Training starts...")
        head = f"{'#iter':<8}| {'Feature':<8}| {scorer.name + '-T':<11}"
        if validation is not None:
            head += f"| {scorer.name + '-V':<11}"
        log(head)
        silent = is_silent()
        if silent:
            from ranklib_tpu.gbdt.boost import run_silent_blocks

            state = run_silent_blocks(step, state, self.n_rounds, S, tb, vb,
                                      qmask)
        for t in ([] if silent else range(self.n_rounds)):
            state = step(state, t, S, tb, vb, qmask)
            if not bool(state.hact[t]):
                log(f"Stop at round {t + 1} (degenerate or rolled back)")
                break
            tm = float(state.train_m[t])
            line = f"{t + 1:<8}| {int(state.hfid[t]) + 1:<8}| {tm:<11.4f}"
            vm = None
            if validation is not None:
                vm = float(state.val_m[t])
                line += f"| {vm:<11.4f}"
            log(line)
            event("round", ranker=self.NAME, round=t + 1,
                  train_metric=tm, val_metric=vm)
            if not bool(state.active):
                break

        hfid, halpha, hact, val_m = jax.device_get(
            (state.hfid, state.halpha, state.hact, state.val_m))
        kept = [t for t in range(self.n_rounds) if hact[t]]
        self.history = [(int(hfid[t]) + 1, float(halpha[t])) for t in kept]
        if validation is not None and kept:
            vals = val_m[kept]
            best = int(np.nanargmax(vals))
            self.history = self.history[: best + 1]
        w = np.zeros(F, np.float64)
        for fid, alpha in self.history:
            w[fid - 1] += alpha
        self.weights = w

    def _fit_sparse_dist(self, train, validation, scorer, mesh, F, Q,
                         n_vq, CAP):
        """Wide-CSR data-parallel fit: the sparse S-matrix build stays
        host-side (adarank_weak_matrix — per-(query, feature) host
        batches, no device residency), then S rows, the COO score layer
        and the metric buckets shard per device (parallel/dp.py
        shard_sparse_data); the step composes ``axis_name`` with
        ``sparse_docs`` so all sums psum and decisions replicate."""
        from jax.sharding import PartitionSpec as P_

        from ranklib_tpu.gbdt.boost_dist import AXIS
        from ranklib_tpu.ops.sparse_eval import adarank_weak_matrix
        from ranklib_tpu.parallel.dp import (
            make_dist_stepper, place_replicated, place_sharded,
            shard_sparse_data,
        )

        n_dev = mesh.devices.size
        S_np = adarank_weak_matrix(train, scorer)
        # per_dev comes FROM shard_sparse_data so the S rows below use
        # the exact dealing the buckets were built from (review finding,
        # round 5: a second _shard_queries call could silently drift)
        chunks, bks, Qpad, Npad, per_dev = shard_sparse_data(
            train, n_dev, mesh)
        S_stack = np.zeros((n_dev, Qpad, F), np.float32)
        qmask_stack = np.zeros((n_dev, Qpad), bool)
        for dev, lst in enumerate(per_dev):
            for j, (_, qi) in enumerate(lst):
                S_stack[dev, j] = S_np[qi]
                qmask_stack[dev, j] = True
        tb = (chunks, bks)
        vb = ()
        n_vslots = n_vq
        Nvpad = 1
        if validation is not None:
            vchunks, vbks, n_vslots, Nvpad, _ = shard_sparse_data(
                validation, n_dev, mesh)
            vb = (vchunks, vbks)
        shd = lambda a: place_sharded(np.asarray(a), mesh)
        rep = lambda a: place_replicated(np.asarray(a), mesh)
        S = shd(S_stack)
        qmask = shd(qmask_stack)
        impl = make_ada_step(
            scorer, no_eq=self.no_eq, max_sel=self.max_sel_count,
            tolerance=self.tolerance, n_queries=Q, n_vqueries=n_vq,
            n_vslots=n_vslots, axis_name=AXIS, raw=True,
            sparse_docs=(Npad, Nvpad))
        sh, rp = P_(AXIS), P_()
        state_specs = AdaState(
            P=sh, w=rp, last_fid=rp, consec=rp, prev_train=rp, active=rp,
            hfid=rp, halpha=rp, hact=rp, train_m=rp, val_m=rp)
        data_specs = (sh, jax.tree.map(lambda _: sh, tb),
                      jax.tree.map(lambda _: sh, vb), sh)
        step = make_dist_stepper(impl, mesh, state_specs, data_specs)
        state = AdaState(
            P=shd(np.where(qmask_stack, np.float32(1.0 / Q),
                           np.float32(0.0))),
            w=rep(np.zeros((F,), np.float32)),
            last_fid=rep(np.int32(-1)), consec=rep(np.int32(0)),
            prev_train=rep(np.float32(-np.inf)),
            active=rep(np.asarray(True)),
            hfid=rep(np.zeros((CAP,), np.int32)),
            halpha=rep(np.zeros((CAP,), np.float32)),
            hact=rep(np.zeros((CAP,), bool)),
            train_m=rep(np.full((CAP,), np.nan, np.float32)),
            val_m=rep(np.full((CAP,), np.nan, np.float32)),
        )
        return self._run_rounds(step, state, S, tb, vb, qmask,
                                validation, scorer)

    def _build_dist(self, train, validation, scorer, mesh, S_np, Q, n_vq,
                    CAP):
        """Data-parallel (S, tb, vb, qmask, step, state) over a
        query-sharded mesh (parallel/dp.py module docstring): P·S, the α
        ratio terms, the reweighting normalizer and the metric sums psum;
        the feature pick replicates. Order-equivalent to single-device
        (per-device partial sums change f32 summation order only)."""
        from jax.sharding import PartitionSpec as P_

        from ranklib_tpu.gbdt.boost_dist import AXIS, _shard_queries
        from ranklib_tpu.ops.batched_eval import _DOC_BUDGET
        from ranklib_tpu.parallel.dp import (
            make_dist_stepper, place_replicated, place_sharded,
            shard_feat_buckets,
        )

        n_dev = mesh.devices.size
        tb, Qpad, per_dev = shard_feat_buckets(
            train, n_dev, mesh, want_qidx=True, doc_budget=_DOC_BUDGET)
        # S rows and P slots in each device's local order
        S_stack = np.zeros((n_dev, Qpad, S_np.shape[1]), np.float32)
        qmask_stack = np.zeros((n_dev, Qpad), bool)
        for dev, lst in enumerate(per_dev):
            for j, (_, qi) in enumerate(lst):
                S_stack[dev, j] = S_np[qi]
                qmask_stack[dev, j] = True
        vb = ()
        n_vslots = n_vq
        if validation is not None:
            vb, n_vslots, _ = shard_feat_buckets(
                validation, n_dev, mesh, want_qidx=True,
                doc_budget=_DOC_BUDGET)
        shd = lambda a: place_sharded(np.asarray(a), mesh)
        rep = lambda a: place_replicated(np.asarray(a), mesh)
        S = shd(S_stack)
        qmask = shd(qmask_stack)
        impl = make_ada_step(
            scorer, no_eq=self.no_eq, max_sel=self.max_sel_count,
            tolerance=self.tolerance, n_queries=Q, n_vqueries=n_vq,
            n_vslots=n_vslots, axis_name=AXIS, raw=True)
        sh, rp = P_(AXIS), P_()
        state_specs = AdaState(
            P=sh, w=rp, last_fid=rp, consec=rp, prev_train=rp, active=rp,
            hfid=rp, halpha=rp, hact=rp, train_m=rp, val_m=rp)
        data_specs = (sh, jax.tree.map(lambda _: sh, tb),
                      jax.tree.map(lambda _: sh, vb), sh)
        step = make_dist_stepper(impl, mesh, state_specs, data_specs)
        state = AdaState(
            P=shd(np.where(qmask_stack, np.float32(1.0 / Q),
                           np.float32(0.0))),
            w=rep(np.zeros((S_np.shape[1],), np.float32)),
            last_fid=rep(np.int32(-1)), consec=rep(np.int32(0)),
            prev_train=rep(np.float32(-np.inf)),
            active=rep(np.asarray(True)),
            hfid=rep(np.zeros((CAP,), np.int32)),
            halpha=rep(np.zeros((CAP,), np.float32)),
            hact=rep(np.zeros((CAP,), bool)),
            train_m=rep(np.full((CAP,), np.nan, np.float32)),
            val_m=rep(np.full((CAP,), np.nan, np.float32)),
        )
        return S, tb, vb, qmask, step, state

    # ---- scoring ---------------------------------------------------------
    def eval_dataset(self, ds: Dataset):
        from ranklib_tpu.data.dataset import query_feats

        if self.weights is None:
            raise RankLibError("Model not trained/loaded")
        w = np.zeros(ds.n_features, np.float32)
        k = min(len(self.weights), len(w))
        w[:k] = self.weights[:k]
        return [query_feats(ds, qi) @ w for qi in range(len(ds.queries))]

    # ---- serialization -----------------------------------------------------
    def model_str(self) -> str:
        head = model_header(self.NAME, {
            "Iteration": self.n_rounds,
            # -noeq DISABLES enqueue-style retraining, so the header says
            # Yes exactly when no_eq is off (ref AdaRank default
            # trainWithEnqueue=true; was inverted — review finding)
            "Train with 'enqueue'": "No" if self.no_eq else "Yes",
        })
        body = " ".join(f"{fid}:{alpha}" for fid, alpha in self.history)
        return head + body + "\n"

    def load_str(self, text: str) -> None:
        _, body = parse_model_params(text)
        self.history = []
        max_fid = 0
        for line in body:
            for tok in line.split():
                fid, _, a = tok.partition(":")
                self.history.append((int(fid), float(a)))
                max_fid = max(max_fid, int(fid))
        if not self.history:
            raise RankLibError("Empty AdaRank model body")
        w = np.zeros(max_fid, np.float64)
        for fid, alpha in self.history:
            w[fid - 1] += alpha
        self.weights = w
