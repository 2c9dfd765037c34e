#!/usr/bin/env python3
"""On-card smoke test: LambdaMART train → test → rank on an NVIDIA GPU.

    python chip_smoke.py             # one card: device, train, rank, kernel
    python chip_smoke.py --chips 4   # only the four-card -dp phase

Drives the RankLib CLI flow users run (``ranklib_tpu.cli.main``) with the
flagship ranker at the full width of MSLR-WEB10K/30K — 136 dense features,
graded labels 0–4, 80–160 docs per query, RankLib's tree defaults (10
leaves, shrinkage 0.1, ``-tc 256``) — on data generated from a seed.

One process holds the card. The CPU references run in child processes
started with ``JAX_PLATFORMS=cpu`` (``--cpu-child``), which never open it.
Every phase fails the script on error; after the last phase the final
line of stdout is one JSON object naming the device as JAX reports it.
Without a GPU the script exits non-zero before any phase and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]

# the training job: shape of MSLR-WEB10K/30K, cut to 1,500 + 500 queries
TRAIN_QUERIES, TEST_QUERIES, N_FEATURES = 1500, 500, 136
N_TREES = 20
SCORE_DOCS, SCORE_TREES, REF_DOCS = 262_144, 1000, 16_384
NDCG_TOL = 0.005             # QUALITY.json's tolerance
SCORE_RTOL = 1e-5            # max |Δscore| ≤ 1e-5·(1 + |score|)


class SmokeFailure(Exception):
    pass


def parse_smi(text: str) -> list[tuple[str, str]]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output → [(name, power limit)] per card."""
    out = []
    for line in text.strip().splitlines():
        name, _, power = line.rpartition(",")
        if not name:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        out.append((name.strip(), power.strip()))
    return out


def result_line(kind: str, count: int) -> str:
    """The final stdout line: device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": int(count)}})


def check(ok: bool, what: str) -> None:
    print(f"  {'PASS' if ok else 'FAIL'}: {what}", flush=True)
    if not ok:
        raise SmokeFailure(what)


def write_letor(ds, path: str) -> None:
    """LETOR text, one row-format call per doc (the fixtures writer
    formats every value separately, ~10× slower at this size)."""
    fmt = ("%d qid:%s " + " ".join(
        f"{j + 1}:%.6g" for j in range(ds.n_features)) + "\n")
    with open(path, "w") as f:
        for q in ds.queries:
            for i in range(q.n):
                f.write(fmt % (int(q.labels[i]), q.qid,
                               *q.feats[i].tolist()))


def make_data(workdir: str, n_train: int, n_test: int, n_features: int):
    # by path, not as ``tests.fixtures``: an installed package named
    # ``tests`` would shadow the checkout's namespace package
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from fixtures import synth_dataset

    paths = []
    for name, nq, seed in (("train", n_train, 3), ("test", n_test, 4)):
        ds = synth_dataset(n_queries=nq, n_features=n_features, min_docs=80,
                           max_docs=160, gmax=4, seed=seed, w_seed=11,
                           signal=2.5)
        p = os.path.join(workdir, f"{name}.txt")
        write_letor(ds, p)
        paths.append(p)
        print(f"  {name}: {nq} queries, {ds.n_docs} docs × {n_features} "
              "features", flush=True)
    return paths


def run_cli(argv: list[str]) -> tuple[str, float]:
    """cli.main in this process → (captured stdout, wall seconds)."""
    from ranklib_tpu.cli import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise SmokeFailure(f"cli {' '.join(argv)} exited {rc}:\n"
                           + buf.getvalue()[-2000:])
    return buf.getvalue(), dt


def parse_test_ndcg(out: str) -> float:
    m = re.search(r"NDCG@10 on test data: ([0-9.]+)", out)
    if not m:
        raise SmokeFailure("no test NDCG@10 in the CLI output")
    return float(m.group(1))


def read_text(path: str) -> str:
    with open(path) as f:
        return f.read()


def read_scores(path: str):
    import numpy as np

    return np.loadtxt(path, usecols=2, dtype=np.float64, ndmin=1)


def train_argv(train: str, test: str, model: str, extra=()) -> list[str]:
    return ["-train", train, "-ranker", "6", "-metric2t", "NDCG@10",
            "-test", test, "-save", model, "-tree", str(N_TREES),
            "-leaf", "10", "-shrinkage", "0.1", "-tc", "256", *extra]


def start_cpu_child(argv: list[str]) -> subprocess.Popen:
    """The CLI on the CPU in a child that never opens the card."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-child",
         json.dumps(argv)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def finish_child(p: subprocess.Popen, what: str) -> str:
    out, _ = p.communicate()
    if p.returncode != 0:
        raise SmokeFailure(f"CPU child ({what}) exited {p.returncode}:\n"
                           + out[-2000:])
    return out


def median_ms(fn, n: int = 7) -> float:
    """Median wall time of ``fn`` (which blocks on its result) over n
    runs after one warm-up run."""
    import numpy as np

    fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


@contextlib.contextmanager
def xla_route(names):
    """Measurement hook: force the XLA path for the named routing entries
    (``ops.routing``) and drop compiled programs, so the same call
    retraces down the other route. Restored (and dropped again) on exit."""
    import jax

    from ranklib_tpu.ops import routing

    saved = {n: getattr(routing, n) for n in names}
    for n in names:
        setattr(routing, n, lambda *a, **k: False)
    jax.clear_caches()
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(routing, n, f)
        jax.clear_caches()


# ---------------------------------------------------------------- phases

def phase_train(label, train, test, work):
    print("[phase 2] train: LambdaMART, the CLI, GPU vs a CPU child",
          flush=True)
    model = os.path.join(work, "model.txt")
    t_child = time.perf_counter()
    child = start_cpu_child(train_argv(train, test,
                                       os.path.join(work, "model_cpu.txt")))
    try:
        out, dt = run_cli(train_argv(train, test, model))
        ndcg_gpu = parse_test_ndcg(out)
        print(f"  [{label}] GPU train+test {N_TREES} trees: {dt:.2f} s "
              f"(includes compilation); test NDCG@10 {ndcg_gpu:.4f}",
              flush=True)
        ndcg_cpu = parse_test_ndcg(finish_child(child, "train"))
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    t_child = time.perf_counter() - t_child
    print(f"  CPU child: test NDCG@10 {ndcg_cpu:.4f} ({t_child:.1f} s "
          "from its start)", flush=True)
    same = read_text(model) == read_text(os.path.join(work, "model_cpu.txt"))
    print(f"  saved models identical: {same}", flush=True)
    check(abs(ndcg_gpu - ndcg_cpu) <= NDCG_TOL,
          f"|ΔNDCG@10| = {abs(ndcg_gpu - ndcg_cpu):.4f} ≤ {NDCG_TOL}")
    return model


def phase_rank(label, model, test, work):
    print("[phase 3] rank: -load -rank -score, GPU vs a CPU child",
          flush=True)
    import numpy as np

    s_gpu, s_cpu = (os.path.join(work, f"scores_{d}.txt")
                    for d in ("gpu", "cpu"))
    child = start_cpu_child(["-load", model, "-rank", test, "-score", s_cpu])
    try:
        _, dt = run_cli(["-load", model, "-rank", test, "-score", s_gpu])
        finish_child(child, "rank")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    a, b = read_scores(s_gpu), read_scores(s_cpu)
    print(f"  [{label}] GPU -rank: {dt:.2f} s (includes compilation); "
          f"{a.size} docs", flush=True)
    check(a.shape == b.shape and bool(np.isfinite(a).all()),
          "finite scores, one per test doc")
    err = float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))
    check(err <= SCORE_RTOL,
          f"max |Δscore|/(1+|score|) = {err:.2e} ≤ {SCORE_RTOL:g}")


def phase_kernels(label, model, test, work):
    print("[phase 4] the scoring kernel compiled for the card vs its plain "
          "reference", flush=True)
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__ as g
    from ranklib_tpu.gbdt.ensemble import _ensemble_eval, _mm_eval
    from ranklib_tpu.ops.forest_eval import forest_eval_triton

    # -- scoring: 262,144 × 136, 1,000 trees × 10 leaves
    ens = g._synthetic_ensemble(n_trees=SCORE_TREES, n_leaves=10,
                                n_features=N_FEATURES,
                                rng=np.random.default_rng(0))
    Xh = np.random.default_rng(1).normal(
        size=(SCORE_DOCS, N_FEATURES)).astype(np.float32)
    X = jnp.asarray(Xh)
    kp, mp = ens._pack_kernel(), ens._pack_matmul(N_FEATURES)
    fe, th, lf, rt, lv, ot, wt, depth = ens._pack()
    Xr = X[:REF_DOCS]
    ref = np.asarray(_ensemble_eval(Xr, fe, th, lf, rt, lv, ot, wt,
                                    depth=depth), np.float64)
    absref = np.asarray(_ensemble_eval(Xr, fe, th, lf, rt, lv, jnp.abs(ot),
                                       jnp.abs(wt), depth=depth), np.float64)
    print("  scoring: exact f32 compares, 0/±1 path dots exact in bf16; "
          "tolerance 1e-5·(1 + Σ_t|w_t·out_t|) vs traversal", flush=True)
    for name, fn in (("triton", lambda: forest_eval_triton(X, *kp)),
                     ("xla", lambda: _mm_eval(X, *mp))):
        s = np.asarray(fn())
        check(s.shape == (SCORE_DOCS,) and bool(np.isfinite(s).all()),
              f"{name}: finite scores for every doc")
        err = float(np.max(np.abs(s[:REF_DOCS] - ref) / (1.0 + absref)))
        check(err <= 1e-5, f"{name}: vs traversal on {REF_DOCS} docs, max "
              f"|Δ|/(1+Σ|w·out|) = {err:.2e}")
    t_k = median_ms(lambda: forest_eval_triton(X, *kp).block_until_ready())
    t_x = median_ms(lambda: _mm_eval(X, *mp).block_until_ready())
    print(f"  [{label}] scoring {SCORE_DOCS} docs × {SCORE_TREES} trees "
          f"(device-resident): triton {t_k:.3f} ms, xla {t_x:.3f} ms "
          "(median of 7)", flush=True)

    # -- end to end, in the flows that use the kernel: the phase-3 -rank
    # run and eval_matrix from host features
    print("  end to end (warm, each route compiled before timing):",
          flush=True)
    e2e = {}
    for route in ("kernel", "xla"):
        with (xla_route(("scoring_kernel",)) if route == "xla" else
              contextlib.nullcontext()):
            argv = ["-load", model, "-rank", test, "-score",
                    os.path.join(work, "scores_ab.txt")]
            t_rank = median_ms(lambda: run_cli(argv), n=3) / 1e3
            t_eval = median_ms(lambda: ens.eval_matrix(Xh), n=5)
        e2e[route] = (t_rank, t_eval)
        print(f"  [{label}] {route:6s}: CLI -rank {t_rank:.3f} s (median "
              f"of 3); eval_matrix {SCORE_DOCS} docs × {SCORE_TREES} trees "
              f"from host {t_eval:.1f} ms (median of 5)", flush=True)
    check(all(np.isfinite(v) for r in e2e.values() for v in r),
          "end-to-end timings recorded")


def phase_four_cards(label, work):
    print("[phase 5] four cards: -dp 4 vs one card, same process",
          flush=True)
    import jax
    import numpy as np

    from ranklib_tpu.gbdt.boost_dist import _place
    from ranklib_tpu.parallel.dist import make_mesh

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} GPUs visible")
    mesh = make_mesh(4)
    ids = sorted(d.id for d in mesh.devices.flat)
    arr = _place(np.arange(64, dtype=np.float32), mesh, sharded=True)
    shard_devs = sorted(s.device.id for s in arr.addressable_shards)
    check(len(set(ids)) == 4 and len(set(shard_devs)) == 4,
          f"mesh over devices {ids}; shards on devices {shard_devs}")
    train, test = make_data(work, 400, 150, N_FEATURES)
    held = []
    for ranker, extra in (("LambdaMART", ["-tree", "10"]),
                          ("RankNet", ["-epoch", "2"])):
        rid = "6" if ranker == "LambdaMART" else "1"
        res = {}
        for dp in ("0", "4"):
            model = os.path.join(work, f"{ranker}_dp{dp}.txt")
            argv = ["-train", train, "-ranker", rid, "-metric2t", "NDCG@10",
                    "-test", test, "-save", model, "-dp", dp, "-silent",
                    *extra]
            out, dt = run_cli(argv)
            res[dp] = (parse_test_ndcg(out), read_text(model), dt)
            print(f"  [{label}] {ranker} -dp {dp}: {dt:.2f} s (includes "
                  f"compilation); test NDCG@10 {res[dp][0]:.4f}", flush=True)
        if res["0"][1] == res["4"][1]:
            held.append(f"{ranker}: identical models")
            check(True, f"{ranker}: -dp 4 model identical to one card")
        else:
            d = abs(res["0"][0] - res["4"][0])
            held.append(f"{ranker}: |ΔNDCG@10| {d:.4f}")
            check(d <= NDCG_TOL, f"{ranker}: models differ (float sums in "
                  f"another order); |ΔNDCG@10| = {d:.4f} ≤ {NDCG_TOL}")
    print("  held: " + "; ".join(held), flush=True)


def cpu_child(argv: list[str]) -> int:
    import jax

    if jax.devices()[0].platform != "cpu":
        raise SystemExit("chip_smoke: the CPU child must run on the CPU")
    sys.path.insert(0, ROOT)
    from ranklib_tpu.cli import main

    return main(argv)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    ap.add_argument("--cpu-child", metavar="ARGV_JSON", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cpu_child:
        return cpu_child(json.loads(args.cpu_child))

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import ranklib_tpu  # noqa: F401 — fail here outside a checkout

    print("[phase 1] device", flush=True)
    cards = parse_smi(subprocess.run(SMI_QUERY, capture_output=True,
                                     text=True, check=True).stdout)
    for name, power in cards:
        print(f"  {name}, {power}", flush=True)
    label = f"{cards[0][0]}, {cards[0][1]}"
    print(f"  JAX: {len(jax.devices())} × {dev.device_kind} "
          f"({dev.platform})", flush=True)
    work = os.path.join(ROOT, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t_start = time.perf_counter()
    try:
        if args.chips == 4:
            phase_four_cards(label, work)
        else:
            print("[phase 2] data", flush=True)
            train, test = make_data(work, TRAIN_QUERIES, TEST_QUERIES,
                                    N_FEATURES)
            model = phase_train(label, train, test, work)
            phase_rank(label, model, test, work)
            phase_kernels(label, model, test, work)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(result_line(dev.device_kind, len(jax.devices())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
