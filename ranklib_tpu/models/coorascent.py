"""Coordinate Ascent ranker (`-ranker 4`).

Linear model wᵀx that DIRECTLY maximizes the IR metric by cyclic coordinate
line search (ref: learning/CoorAscent.java:~30): weights start uniform
1/F; per restart, features are visited in a (deterministically) shuffled
order; each coordinate is line-searched over a geometric grid of deltas in
both signs; weights re-normalize to Σ|w| = 1; a change is kept only if the
metric gain exceeds the tolerance; best restart wins. Optional L2 penalty
`-reg` subtracts λΣw² from the objective.

Array redesign: the reference evaluates ONE candidate weight vector at a time
(25 sequential metric evaluations per coordinate). Here a full SWEEP over
all coordinates is one jitted ``lax.scan``, with every restart advancing in
lockstep (vmapped [R, ...] state) and every candidate in a coordinate's
geometric ladder — both signs, sign flip, zeroing — scored by one batched
matmul + vmapped metric call per bucket chunk. The host syncs once per
sweep (on the per-restart improved flags), not once per coordinate, where
the reference's structure would pay a host round trip per candidate.
Lockstep restarts are semantically identical to the reference's
independent restarts: a converged restart re-evaluates the same
candidates and keeps finding no gain (deterministic fixed point).

Hyperparameters (reference flags): -r nRestart=5, -i nMaxIteration=25
(line-search depth per coordinate), -tolerance 0.001, -reg off.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ranklib_tpu.data.dataset import Dataset
from ranklib_tpu.metrics.base import MetricScorer
from ranklib_tpu.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu.ops.batched_eval import LinearMetricEvaluator
from ranklib_tpu.utils.errors import RankLibError
from ranklib_tpu.utils.logging import event, log


def make_sweep(scorer, *, n_features: int, depth: int, reg: float | None,
               tolerance: float, n_queries: int, step_base: float,
               step_scale: float, sparse_n: int | None = None,
               axis_name: str | None = None, raw: bool = False):
    """Build the jitted one-sweep fn: (w, cur, order_T, buckets) →
    (w, cur, improved). Shapes: w [R, F], cur [R], order_T [F, R].

    ``sparse_n``: set to the doc count when ``buckets`` is the sparse
    device pytree of ops.sparse_eval (wide CSR data — candidate scores
    come from the gather/segment-sum embedding layer instead of dense
    [B, D, F] matmuls, lifting the HBM ceiling).

    ``axis_name``: set when the sweep runs per-device inside ``shard_map``
    (queries sharded over a mesh, parallel/dp.py) — the candidate metric
    totals psum, so every device takes identical coordinate decisions.
    ``raw`` returns the untraced body for the shard_map wrapper."""
    F = n_features

    def mean_metric(Wc, buckets):
        """Wc [R, C, F] → mean metric [R, C] over all queries."""
        R, C = Wc.shape[0], Wc.shape[1]
        Wf = Wc.reshape(R * C, F)
        if sparse_n is not None:
            from ranklib_tpu.ops.sparse_eval import sparse_mean_metric

            chunks, sbuckets = buckets
            vals = sparse_mean_metric(scorer, Wf.T, chunks, sbuckets,
                                      sparse_n, n_queries,
                                      axis_name=axis_name)
            return vals.reshape(R, C)
        total = jnp.zeros((R * C,), jnp.float32)
        for feats, labels, mask in buckets:
            sc = jnp.einsum("bdf,cf->bdc", feats, Wf,
                            preferred_element_type=jnp.float32)
            vals = jax.vmap(
                lambda s: scorer.score_from_scores(labels, s, mask),
                in_axes=2, out_axes=1)(sc)
            total += vals.sum(axis=0)
        if axis_name:
            total = jax.lax.psum(total, axis_name)
        return total.reshape(R, C) / n_queries

    def coordinate_step(carry, f, buckets):
        w, cur, improved = carry                       # [R, F], [R], [R]
        R = w.shape[0]
        rr = jnp.arange(R)
        w_f = w[rr, f]
        base = step_base * jnp.maximum(jnp.abs(w_f), 0.05)
        mags = base[:, None] * (step_scale ** jnp.arange(depth,
                                                         dtype=jnp.float32))
        deltas = jnp.concatenate(
            [mags, -mags, -w_f[:, None], -2.0 * w_f[:, None]], axis=1)
        onehot = (jnp.arange(F)[None, :] == f[:, None]).astype(jnp.float32)
        Wc = w[:, None, :] + deltas[:, :, None] * onehot[:, None, :]
        norms = jnp.abs(Wc).sum(axis=2)                # [R, C]
        ok = norms > 1e-12
        Wc = Wc / jnp.where(ok, norms, 1.0)[:, :, None]
        vals = mean_metric(Wc, buckets)
        if reg is not None:
            vals = vals - reg * (Wc * Wc).sum(axis=2)
        vals = jnp.where(ok, vals, -jnp.inf)
        cbest = jnp.argmax(vals, axis=1)               # [R]
        vbest = vals[rr, cbest]
        gain = vbest > cur + tolerance
        w = jnp.where(gain[:, None], Wc[rr, cbest], w)
        cur = jnp.where(gain, vbest, cur)
        return (w, cur, improved | gain), None

    def sweep_impl(w, cur, order_T, buckets):
        improved = jnp.zeros(w.shape[0], bool)
        (w, cur, improved), _ = jax.lax.scan(
            functools.partial(coordinate_step, buckets=buckets),
            (w, cur, improved), order_T)
        return w, cur, improved

    if raw:
        # expose the candidate-metric instrument so the mesh caller can
        # compute the BASELINE with the exact same math (einsum + psum)
        # as the sweep's candidates — a host-side baseline diverging by
        # more than tolerance from the device instrument could flip
        # first-sweep decisions (review finding)
        sweep_impl.mean_metric = mean_metric
        return sweep_impl
    return jax.jit(sweep_impl)


@register_ranker
class CoorAscent(Ranker):
    NAME = "Coordinate Ascent"

    STEP_BASE = 0.05
    STEP_SCALE = 2.0

    def __init__(self, **hp):
        self.n_restart = 5
        self.n_max_iteration = 25     # geometric-ladder depth per coordinate
        self.tolerance = 0.001
        self.reg = None               # L2 penalty weight (None = off)
        self.max_passes = 25          # full feature sweeps per restart
        self.seed = 0                 # -randomSeed: offsets restart shuffles
        self.weights = None           # np.float64 [F], Σ|w| = 1
        super().__init__(**hp)

    def fit(self, train: Dataset, scorer: MetricScorer, validation=None,
            mesh=None):
        from ranklib_tpu.ops.sparse_eval import wants_sparse_eval

        F = train.n_features
        R = self.n_restart
        sparse_n = None
        use_sparse = wants_sparse_eval(train)
        if use_sparse and mesh is not None:
            # -sparse -dp cross product (round-5): the COO score layer
            # and metric buckets shard per device
            # (parallel/dp.py shard_sparse_data; qidx channel unused —
            # the candidate metric sums queries directly); per-device
            # totals psum inside sparse_mean_metric, so every
            # coordinate decision replicates
            from ranklib_tpu.parallel.dp import shard_sparse_data

            n_dev = mesh.devices.size
            chunks, sbk3, _, sparse_n, _ = shard_sparse_data(
                train, n_dev, mesh, want_qidx=False)
            buckets = (chunks, sbk3)
        elif use_sparse:
            # wide CSR data: dense [B, D, F] bucket residency would blow
            # the HBM budget — candidate scores come from the device COO
            # via the gather/segment-sum embedding layer instead
            from ranklib_tpu.ops.sparse_eval import (
                build_sparse_data, sparse_mean_metric,
            )

            chunks, sbuckets, sparse_n = build_sparse_data(train)
            buckets = (chunks, sbuckets)

            def _mean0(w_col):
                return float(np.asarray(sparse_mean_metric(
                    scorer, jnp.asarray(w_col), chunks, sbuckets, sparse_n,
                    len(train.queries)))[0])
        elif mesh is not None:
            # queries sharded over the mesh (parallel/dp.py): the sweep's
            # candidate metric totals psum per coordinate, decisions
            # replicate — order-equivalent to single-device
            from ranklib_tpu.ops.batched_eval import _DOC_BUDGET
            from ranklib_tpu.parallel.dp import shard_feat_buckets

            n_dev = mesh.devices.size
            # same [rows·D] cap as the single-device evaluator: the
            # sweep's [rows, D, R·C] candidate-score temporary must stay
            # bounded per device
            buckets, _, _ = shard_feat_buckets(train, n_dev, mesh,
                                               doc_budget=_DOC_BUDGET)
            # _mean0 for this branch is defined AFTER the sweep is built
            # (it reuses the sweep's own psum'd metric instrument)
        else:
            ev = LinearMetricEvaluator(train, scorer)
            buckets = tuple((f, l, m) for f, l, m, _ in ev.buckets)

            def _mean0(w_col):
                return float(ev.mean_metric(w_col)[0])
        # same deterministic per-restart orders as the reference's shuffle;
        # -randomSeed offsets the streams so restarts differ run-to-run
        # when asked (the reference reshuffles every restart)
        order_T = jnp.asarray(np.stack(
            [np.random.default_rng(self.seed + r).permutation(F)
             for r in range(R)],
            axis=1).astype(np.int32))                  # [F, R]
        # honor -i exactly, even below the old floor of 4 (review
        # finding: max(4, i) silently widened the candidate ladder)
        depth = max(1, self.n_max_iteration)

        if mesh is not None:
            from jax.sharding import PartitionSpec as P_

            from ranklib_tpu.gbdt.boost_dist import AXIS
            from ranklib_tpu.parallel.dp import _tree_sq

            impl = make_sweep(
                scorer, n_features=F, depth=depth, reg=self.reg,
                tolerance=self.tolerance, n_queries=len(train.queries),
                step_base=self.STEP_BASE, step_scale=self.STEP_SCALE,
                sparse_n=sparse_n, axis_name=AXIS, raw=True)
            sh, rp = P_(AXIS), P_()
            bucket_specs = jax.tree.map(lambda _: sh, buckets)

            def per_device(w_, cur_, oT_, bk_):
                return impl(w_, cur_, oT_, _tree_sq(bk_, bucket_specs, sh))

            sweep = jax.jit(jax.shard_map(
                per_device, mesh=mesh,
                in_specs=(rp, rp, rp, bucket_specs),
                out_specs=(rp, rp, rp), check_vma=False))

            def _bl_dev(bk_, Wc):
                return impl.mean_metric(Wc,
                                        _tree_sq(bk_, bucket_specs, sh))

            _bl = jax.jit(jax.shard_map(
                _bl_dev, mesh=mesh, in_specs=(bucket_specs, rp),
                out_specs=rp, check_vma=False))

            def _mean0(w_col):
                # SAME instrument as the sweep's candidates (einsum +
                # psum), not a host-side recomputation — the baseline
                # and the candidates must agree to sub-tolerance
                Wc = jnp.asarray(
                    np.asarray(w_col, np.float32).T)[:, None, :]
                return float(np.asarray(_bl(buckets, Wc))[0, 0])
        else:
            sweep = make_sweep(
                scorer, n_features=F, depth=depth, reg=self.reg,
                tolerance=self.tolerance, n_queries=len(train.queries),
                step_base=self.STEP_BASE, step_scale=self.STEP_SCALE,
                sparse_n=sparse_n)

        w = jnp.full((R, F), 1.0 / F, jnp.float32)
        cur0 = _mean0(np.full((F, 1), 1.0 / F, np.float32))
        if self.reg is not None:
            cur0 -= self.reg * (1.0 / F)     # Σ(1/F)² over F coordinates
        cur = jnp.full((R,), cur0, jnp.float32)

        log(f"Training starts... [{self.NAME}] optimizing {scorer.name} "
            f"({R} restarts in lockstep)")
        for sweep_i in range(self.max_passes):
            w, cur, improved = sweep(w, cur, order_T, buckets)
            imp = np.asarray(improved)                 # ONE sync per sweep
            curs = np.asarray(cur)
            log(f"  pass {sweep_i + 1}: {scorer.name} = "
                f"{float(curs.max()):.4f} "
                f"({int(imp.sum())}/{R} restarts improving)")
            event("sweep", ranker=self.NAME, sweep=sweep_i + 1,
                  best_metric=float(curs.max()),
                  improving=int(imp.sum()))
            if not imp.any():
                break
        curs = np.asarray(cur, np.float64)
        ws = np.asarray(w, np.float64)
        best = int(np.argmax(curs))
        # final f64 renormalization: device math is f32, the model-file
        # invariant Σ|w| = 1 is kept at double precision like the reference
        wbest = ws[best]
        norm = np.abs(wbest).sum()
        self.weights = wbest / (norm if norm > 0 else 1.0)
        log("-" * 40)
        log(f"Finished successfully. {scorer.name} on training data: "
            f"{curs[best]:.4f}")
        if validation is not None:
            wv = self.weights[:, None].astype(np.float32)
            if wants_sparse_eval(validation):
                from ranklib_tpu.ops.sparse_eval import (
                    build_sparse_data, sparse_mean_metric,
                )

                vc, vbk, vn = build_sparse_data(validation)
                vm = float(np.asarray(sparse_mean_metric(
                    scorer, jnp.asarray(wv), vc, vbk, vn,
                    len(validation.queries)))[0])
            else:
                ev_val = LinearMetricEvaluator(validation, scorer)
                vm = float(ev_val.mean_metric(wv)[0])
            log(f"{scorer.name} on validation data: {vm:.4f}")

    # ---- scoring / io ------------------------------------------------------
    def eval_dataset(self, ds: Dataset):
        from ranklib_tpu.data.dataset import query_feats

        if self.weights is None:
            raise RankLibError("Model not trained/loaded")
        w = np.zeros(ds.n_features, np.float64)
        n = min(len(self.weights), ds.n_features)
        w[:n] = self.weights[:n]
        wf = w.astype(np.float32)
        return [query_feats(ds, qi) @ wf for qi in range(len(ds.queries))]

    def model_str(self) -> str:
        hdr = model_header(
            self.NAME,
            {
                "Restart": self.n_restart,
                "MaxIteration": self.n_max_iteration,
                "StepBase": self.STEP_BASE,
                "StepScale": self.STEP_SCALE,
                "Tolerance": self.tolerance,
                "Regularized": self.reg is not None,
                "Slack": self.reg if self.reg is not None else 0,
            },
        )
        body = " ".join(
            f"{i + 1}:{self.weights[i]}" for i in range(len(self.weights))
        )
        return hdr + body + "\n"

    def load_str(self, text: str) -> None:
        _, body = parse_model_params(text)
        if not body:
            raise RankLibError("Empty Coordinate Ascent model body")
        pairs = body[0].split()
        max_fid = max(int(p.split(":")[0]) for p in pairs)
        w = np.zeros(max_fid, np.float64)
        for p in pairs:
            fid, _, v = p.partition(":")
            w[int(fid) - 1] = float(v)
        self.weights = w
