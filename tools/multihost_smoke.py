"""REAL multi-process validation of the distributed training path.

`tests/test_parallel.py` proves the psum'd tree grower bit-matches the
single-device grower on a single-process 8-device mesh. This tool runs
the SAME check across genuinely separate processes wired together with
``jax.distributed.initialize`` (Gloo collectives standing in for the
card links) — the actual multi-host program shape of
``parallel/dist.py``'s design (SURVEY.md §5 communication row): on GPU
hosts the identical code runs with ``jax.distributed.initialize`` given
the coordinator address, process count and process id.

Usage (launcher spawns the workers):

    python tools/multihost_smoke.py [--nprocs 2] [--devices-per-proc 4]

Each worker builds the same deterministic batch, computes the
single-device reference tree locally, then joins the global
``nprocs × devices_per_proc``-device mesh, runs the shard_map'd
distributed round (histograms/node stats psum over the process
boundary), and asserts the tree is IDENTICAL. Exit 0 = pass.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_batch(n_dev: int, B_per=2, D=16, F=6, seed=0):
    import numpy as np

    from ranklib_tpu.gbdt.binning import bin_features, compute_thresholds

    rng = np.random.default_rng(seed)
    B = n_dev * B_per
    feats = rng.normal(size=(B * D, F)).astype(np.float32)
    thresholds, _ = compute_thresholds(feats, 16)
    binned = bin_features(feats, thresholds)
    labels = rng.integers(0, 3, size=(B, D)).astype(np.float32)
    mask = np.ones((B, D), dtype=bool)
    mask[:, 13:] = False
    labels[~mask] = 0.0
    return binned.reshape(B, D, F), labels, mask, thresholds.shape[1]


def worker(pid: int, nprocs: int, dev_per: int, port: int) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nprocs, process_id=pid)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, REPO)
    from ranklib_tpu.gbdt.grow import grow_tree, leaf_outputs
    from ranklib_tpu.gbdt.lambdas import lambda_weights
    from ranklib_tpu.metrics.base import create_scorer
    from ranklib_tpu.parallel.dist import AXIS, make_train_step

    n_dev = nprocs * dev_per
    assert jax.device_count() == n_dev, (
        f"global devices {jax.device_count()} != {n_dev}")
    assert jax.local_device_count() == dev_per

    binned, labels, mask, n_bins = build_batch(n_dev)
    B, D, F = binned.shape
    scorer = create_scorer("NDCG@10")
    scores0 = np.zeros((B, D), np.float32)

    # ---- single-device reference (local) ---------------------------------
    lam, w = lambda_weights(scorer, jnp.asarray(labels),
                            jnp.asarray(scores0), jnp.asarray(mask))
    g = jnp.asarray(np.asarray(lam).reshape(-1))
    ww = jnp.asarray(np.asarray(w).reshape(-1))
    dm = jnp.asarray(mask.reshape(-1))
    tree1 = grow_tree(jnp.asarray(binned.reshape(-1, F).T), g,
                      n_bins=n_bins, n_leaves=4, doc_mask=dm)
    out1 = leaf_outputs(tree1.node_of_doc, g, ww, 7, True, doc_mask=dm)
    ref = jax.device_get((tree1.feature, tree1.bin, tree1.left, out1))

    # ---- distributed: global mesh spanning both processes ----------------
    mesh = Mesh(np.array(jax.devices()).reshape(-1), (AXIS,))
    step = make_train_step(scorer, n_bins=n_bins, n_leaves=4,
                           min_leaf_support=1, learning_rate=0.1, mesh=mesh)

    sh = NamedSharding(mesh, P(AXIS))
    rows = B // nprocs                       # rows owned by this process

    def to_global(a):
        local = np.ascontiguousarray(a[pid * rows:(pid + 1) * rows])
        return jax.make_array_from_process_local_data(sh, local)

    b = to_global(binned)
    l = to_global(labels)
    m = to_global(mask)
    s = to_global(scores0)
    new_scores, tree_d, out_d = step(b, l, m, s)
    got = jax.device_get((tree_d.feature, tree_d.bin, tree_d.left, out_d))

    ok = (np.array_equal(ref[0], got[0]) and np.array_equal(ref[1], got[1])
          and np.array_equal(ref[2], got[2])
          and np.allclose(ref[3], got[3], rtol=1e-4, atol=1e-5))
    print(f"[worker {pid}] global={jax.device_count()} devices "
          f"split={ref[0][0]}@bin{ref[1][0]} "
          f"{'MATCH' if ok else 'DIVERGED'}", flush=True)

    # ---- stage 2: the PRODUCT distributed fit across processes -----------
    import hashlib

    from jax.experimental import multihost_utils

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from fixtures import synth_dataset
    from ranklib_tpu.models.gbdt import LambdaMART
    from ranklib_tpu.utils.logging import set_silent

    set_silent(True)
    train = synth_dataset(n_queries=4 * n_dev, n_features=8, min_docs=6,
                          max_docs=14, seed=0, w_seed=1, signal=3.0)
    lm = LambdaMART(n_trees=3, n_leaves=4, learning_rate=0.2)
    lm.fit(train, scorer, mesh=mesh)
    model_text = lm.model_str()
    # uint32: process_allgather silently truncates uint64 under x32 mode
    digest = np.frombuffer(
        hashlib.sha256(model_text.encode()).digest()[:4], np.uint32)
    all_digests = np.asarray(multihost_utils.process_allgather(digest))
    same = bool((all_digests == all_digests.flat[0]).all())
    m_dist = lm.score_metric(train, scorer)
    single = LambdaMART(n_trees=3, n_leaves=4, learning_rate=0.2)
    single.fit(train, scorer)
    m_single = single.score_metric(train, scorer)
    ok2 = same and len(lm.ensemble) == 3 and abs(m_dist - m_single) < 0.05
    print(f"[worker {pid}] product fit(mesh): model identical across "
          f"processes={same}, NDCG dist={m_dist:.4f} single={m_single:.4f} "
          f"{'MATCH' if ok2 else 'DIVERGED'}", flush=True)

    # ---- stage 3: a NON-TREE DP fit across processes (round 4) -----------
    # RankBoost's psum'd Z / weak-search histogram / metric sums ride the
    # same Gloo collectives; the weak-ranker sequence must match the
    # single-device fit and replicate identically on every process.
    from ranklib_tpu.models.rankboost import RankBoost

    rb = RankBoost(n_rounds=5)
    rb.fit(train, scorer, mesh=mesh)
    rb1 = RankBoost(n_rounds=5)
    rb1.fit(train, scorer)
    seq_ok = (len(rb.weaks) == len(rb1.weaks) > 0 and all(
        a[0] == b[0] and abs(a[1] - b[1]) < 1e-6 and abs(a[2] - b[2]) < 1e-4
        for a, b in zip(rb.weaks, rb1.weaks)))
    rb_text = " ".join(f"{f}:{t:.6g}:{a:.6g}" for f, t, a in rb.weaks)
    rb_digest = np.frombuffer(
        hashlib.sha256(rb_text.encode()).digest()[:4], np.uint32)
    rb_all = np.asarray(multihost_utils.process_allgather(rb_digest))
    rb_same = bool((rb_all == rb_all.flat[0]).all())
    ok3 = seq_ok and rb_same
    print(f"[worker {pid}] RankBoost fit(mesh): weak seq matches "
          f"single={seq_ok}, identical across processes={rb_same} "
          f"{'MATCH' if ok3 else 'DIVERGED'}", flush=True)
    return 0 if (ok and ok2 and ok3) else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--port", type=int, default=0,
                    help="coordinator port (0 = pick a free one)")
    ap.add_argument("--worker", type=int, default=None)
    args = ap.parse_args()

    if args.worker is not None:
        return worker(args.worker, args.nprocs, args.devices_per_proc,
                      args.port)

    if args.port == 0:
        import socket

        with socket.socket() as s:      # free port: avoids collisions
            s.bind(("127.0.0.1", 0))    # between concurrent runs
            args.port = s.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        f" --xla_force_host_platform_device_count="
                        f"{args.devices_per_proc}").strip()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(i), "--nprocs", str(args.nprocs),
             "--devices-per-proc", str(args.devices_per_proc),
             "--port", str(args.port)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(args.nprocs)
    ]
    rc = 0
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            sys.stdout.write(out[-2000:])
            rc |= p.returncode
    finally:
        for p in procs:                 # no orphans holding the port
            if p.poll() is None:
                p.kill()
    print("MULTIHOST SMOKE:", "PASS" if rc == 0 else "FAIL")
    return rc


if __name__ == "__main__":
    sys.exit(main())
