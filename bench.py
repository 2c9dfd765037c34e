"""Headline benchmark: LambdaMART training throughput (doc·trees/sec/chip).

Runs on the GPU only: on any other platform it exits non-zero before
measuring anything. It generates deterministic synthetic MSLR-shaped data
(136 features, 80–160 docs/query, graded labels 0..4; no dataset ships
with the repo).

Baseline: single-thread Java RankLib LambdaMART sustains on the order of
1e5 doc·trees/sec on MSLR-WEB10K-class data (~720K docs at roughly 7 s per
tree). ``vs_baseline`` is measured throughput / 1e5.

Method: train a fresh model for 2 trees (compiles every jit kernel), then
fresh models for 2 and 502 trees (both compile-cached); the warm
difference times exactly 500 steady-state boosting rounds. Fits run in
silent mode (the lambda phase, tree growth, leaf outputs and score
updates; validation alone drives early stopping), which chains the
rounds on the device with no per-round host sync.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"backend", "device", "extra_metrics"}.
"""

import json
import sys
import time

JAVA_BASELINE_DOCTREES_PER_SEC = 1.0e5


def main() -> int:
    import os

    import jax

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from ranklib_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, found platform {dev.platform!r}; "
              "refusing to measure", file=sys.stderr, flush=True)
        return 1
    print(f"bench backend: {jax.default_backend()} "
          f"(devices: {jax.devices()})", file=sys.stderr, flush=True)

    import numpy as np

    from ranklib_tpu.metrics.base import create_scorer
    from ranklib_tpu.models.gbdt import LambdaMART
    from ranklib_tpu.utils.logging import set_silent
    sys.path.insert(0, os.path.join(root, "tests"))
    from fixtures import synth_dataset

    set_silent(True)
    trees = 502
    train = synth_dataset(n_queries=1500, n_features=136, min_docs=80,
                          max_docs=160, gmax=4, seed=3, w_seed=11, signal=2.5)
    n_docs = train.n_docs
    scorer = create_scorer("NDCG@10")

    def timed_fit(n_trees: int) -> float:
        r = LambdaMART(n_trees=n_trees, n_leaves=10, learning_rate=0.1,
                       early_stop=0)
        t0 = time.perf_counter()
        r.fit(train, scorer)
        dt = time.perf_counter() - t0
        print(f"bench fit({n_trees}): {dt:.1f}s", file=sys.stderr, flush=True)
        return dt

    def round_ms_probe() -> float | None:
        """Independent chained-dispatch instrument: K fused rounds per
        host value-read via step.multi — device time per round with no
        per-round dispatch in the loop. Same config as the silent bench
        fits, so the executable is already compiled in-process."""
        import jax.numpy as jnp

        from ranklib_tpu.data.dataset import flatten
        from ranklib_tpu.gbdt.binning import bin_features, compute_thresholds
        from ranklib_tpu.gbdt.boost import (
            init_state, make_boost_data, make_round_step,
        )
        from ranklib_tpu.models.gbdt import _pad_doc_count

        feats, labels, _ = flatten(train)
        N, F = feats.shape
        thresholds, _ = compute_thresholds(feats, 256)
        Npad = _pad_doc_count(N)
        binned = bin_features(np.pad(feats, ((0, Npad - N), (0, 0))),
                              thresholds)
        labels_pad = np.pad(labels, (0, Npad - N)).astype(np.float32)
        data, Npad, Nvpad = make_boost_data(train, binned, labels_pad, N,
                                            None, None, None, scorer=scorer)
        step = make_round_step(
            scorer, n_bins=thresholds.shape[1], n_leaves=10,
            min_leaf_support=1, learning_rate=0.1, pointwise=False,
            newton=True, n_queries=len(train.queries), n_vqueries=1,
            train_metric=False)
        K = 40
        state = init_state(3 * K + 1, 10, Npad, Nvpad, F)
        state = step.multi(state, jnp.int32(0), jnp.int32(1), data)
        float(state.scores[0])                 # warm + VALUE READ
        best = None
        for rep in range(3):
            t0 = time.perf_counter()
            state = step.multi(state, jnp.int32(1 + rep * K),
                               jnp.int32(1 + (rep + 1) * K), data)
            float(state.scores[0])
            dt = (time.perf_counter() - t0) / K
            best = dt if best is None else min(best, dt)
        return round(best * 1e3, 2)

    def extra_metrics() -> dict:
        """Secondary machine-readable numbers: serving latency and the
        other fused-loop rankers at fixed shapes. Every block is
        independently guarded — a failure records null rather than
        sinking the primary metric."""
        import jax.numpy as jnp

        extra = {}
        try:
            extra["round_ms_probe"] = round_ms_probe()
        except Exception as e:                 # noqa: BLE001
            print(f"bench round probe failed: {e!r}", file=sys.stderr)
            extra["round_ms_probe"] = None
        # every extra runs 3 reps and records its spread next to the best
        reps = 3

        def _best_spread(fn, n=reps):
            ts = []
            for _ in range(n):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            return min(ts), max(ts) - min(ts)

        # shaped key names fixed up front so FAILURE records land under
        # the same keys a success would (a null under a mismatched key
        # reads as "not run" instead of "failed" — review finding)
        n_serve, trees_serve = 262144, 1000
        k_eval = f"serving_eval_ms_{n_serve}docs_{trees_serve}trees"
        k_e2e = f"serving_e2e_ms_{n_serve}docs_{trees_serve}trees"
        # the shared serving fixtures build OUTSIDE the per-extra guards:
        # both serving blocks need them, and a construction failure must
        # null BOTH shaped keys instead of surfacing as a NameError in
        # the second block (review finding). Xh draws from its own seed
        # so the e2e input never depends on how far the eval block got.
        ens = None
        try:
            from __graft_entry__ import _synthetic_ensemble
            ens = _synthetic_ensemble(n_trees=trees_serve, n_leaves=10,
                                      n_features=136,
                                      rng=np.random.default_rng(0))
            Xh = np.asarray(np.random.default_rng(1)
                            .normal(size=(n_serve, 136)), np.float32)
        except Exception as e:                 # noqa: BLE001
            print(f"bench serving fixtures failed: {e!r}", file=sys.stderr)
            extra[k_eval] = extra[k_e2e] = None
        try:                                   # ---- serving eval
            if ens is None:
                raise RuntimeError("serving fixtures unavailable")
            Xs = jnp.asarray(Xh)
            # the routed serving path (the Triton kernel on the GPU)
            ev, _ = ens._device_eval_fn(136)
            float(ev(Xs).sum())                # compile + warm
            best, spread = _best_spread(lambda: float(ev(Xs).sum()))
            extra[k_eval] = round(best * 1e3, 1)
            extra["serving_eval_spread_ms"] = round(spread * 1e3, 1)
        except Exception as e:                 # noqa: BLE001
            print(f"bench extra serving failed: {e!r}", file=sys.stderr)
            extra[k_eval] = None
        try:                       # ---- end-to-end serving (HOST feats)
            # the full eval_matrix path a CLI user pays: f32 upload +
            # kernel + download
            if ens is None:
                raise RuntimeError("serving fixtures unavailable")
            ens.eval_matrix(Xh)                # compile + warm
            best, spread = _best_spread(lambda: ens.eval_matrix(Xh))
            extra[k_e2e] = round(best * 1e3, 1)
            extra["serving_e2e_spread_ms"] = round(spread * 1e3, 1)
        except Exception as e:                 # noqa: BLE001
            print(f"bench extra serving e2e failed: {e!r}", file=sys.stderr)
            extra[k_e2e] = None
        for name, make in (
            ("rankboost", lambda R: __import__(
                "ranklib_tpu.models.rankboost", fromlist=["RankBoost"]
            ).RankBoost(n_rounds=R)),
            ("adarank", lambda R: __import__(
                "ranklib_tpu.models.adarank", fromlist=["AdaRank"]
            ).AdaRank(n_rounds=R)),
        ):
            R = 300
            try:
                make(2).fit(train, scorer)     # compile
                best, spread = _best_spread(lambda: make(R).fit(train, scorer))
                extra[f"{name}_{R}rounds_s"] = round(best, 2)
                extra[f"{name}_spread_s"] = round(spread, 2)
            except Exception as e:             # noqa: BLE001
                print(f"bench extra {name} failed: {e!r}", file=sys.stderr)
                extra[f"{name}_{R}rounds_s"] = None
        E = 100
        try:                                   # ---- RankNet at ref defaults
            from ranklib_tpu.models.neural import RankNet
            RankNet(n_epoch=2).fit(train, scorer)     # compile
            best, spread = _best_spread(
                lambda: RankNet(n_epoch=E).fit(train, scorer))
            extra[f"ranknet_{E}epochs_s"] = round(best, 2)
            extra["ranknet_spread_s"] = round(spread, 2)
        except Exception as e:                 # noqa: BLE001
            print(f"bench extra ranknet failed: {e!r}", file=sys.stderr)
            extra[f"ranknet_{E}epochs_s"] = None
        return extra

    cold_compile_s = timed_fit(2)  # cold: compiles every jit kernel
    # best-of-3 on each warm measurement
    t_small = min(timed_fit(2) for _ in range(3))
    bigs = [timed_fit(trees) for _ in range(3)]
    fit_spread_s = round(max(bigs) - min(bigs), 2)
    steady = max(min(bigs) - t_small, 1e-9)
    doctrees_per_sec = n_docs * (trees - 2) / steady

    extra = extra_metrics()
    extra["cold_compile_s"] = round(cold_compile_s, 1)
    extra["fit_spread_s"] = fit_spread_s
    extra["round_ms_fit_diff"] = round(steady / (trees - 2) * 1e3, 2)
    # Instrument cross-check: fit-differencing subtracts a small-fit
    # baseline whose upload/compile overhead varies; the chained-dispatch
    # probe times K donated silent rounds with one value read. When the
    # two disagree by >30%, the probe is the headline; both always appear
    # in extra_metrics.
    probe_ms = extra.get("round_ms_probe")
    if probe_ms:
        fit_ms = steady / (trees - 2) * 1e3
        if abs(fit_ms - probe_ms) / probe_ms > 0.30:
            doctrees_per_sec = n_docs / (probe_ms * 1e-3)
            extra["headline_instrument"] = "round_ms_probe"

    print(json.dumps({
        "metric": "lambdamart_train_throughput",
        "value": round(doctrees_per_sec, 1),
        "unit": "doc_trees/sec/chip",
        "vs_baseline": round(doctrees_per_sec / JAVA_BASELINE_DOCTREES_PER_SEC, 3),
        "backend": jax.default_backend(),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra_metrics": extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
