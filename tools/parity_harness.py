"""Numerical-parity harness vs. the Java RankLib jar (SURVEY.md §4).

Runs the SAME train/test files through this framework's CLI and through
``java -jar RankLib.jar`` with equivalent flags, then compares:

* the printed train/test metric (target: NDCG@10 within ±0.002 —
  parity goal);
* model-file cross-loading: our saved model evaluated by the jar and the
  jar's model evaluated by us must score identically (±1e-4 per query).

The reference mount (/root/reference) was EMPTY at build time and no JVM
ships in this image, so this harness self-skips unless both a jar and a
``java`` binary are reachable. Usage once they are::

    python tools/parity_harness.py --jar RankLib.jar \
        --train train.txt --test test.txt [--ranker 6] [--metric NDCG@10]

Exit code 0 = parity holds, 1 = divergence, 2 = prerequisites missing.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

TOL_METRIC = 0.002
TOL_SCORE = 1e-4


def _run(cmd: list[str]) -> str:
    print("+", " ".join(cmd), file=sys.stderr)
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
    if out.returncode != 0:
        print(out.stdout + out.stderr, file=sys.stderr)
        raise RuntimeError(f"command failed: {cmd[0]}")
    return out.stdout


def _metric_from_output(text: str, which: str) -> float:
    # both CLIs print "<METRIC> on <which> data: <value>"
    m = re.search(rf"on {which} data:\s*([0-9.]+)", text)
    if not m:
        raise RuntimeError(f"no '{which}' metric in output:\n{text}")
    return float(m.group(1))


def _scores(cli: list[str], model: str, test: str, out: str) -> list[float]:
    _run(cli + ["-load", model, "-rank", test, "-score", out])
    vals = []
    for line in Path(out).read_text().splitlines():
        parts = line.split()
        if parts:
            vals.append(float(parts[-1]))
    return vals


def run_oracle_mode(args) -> int:
    """Jar-free parity: the production engine vs tools/oracle.py (an
    independent pure-numpy f64 implementation of the reference algorithm).
    Compares per-tree structure, final per-query scores, and the train/test
    metric — the same contract the jar comparison would check, against an
    implementation that shares no code with the engine."""
    import numpy as np

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from ranklib_tpu.data.letor import read_letor
    from ranklib_tpu.metrics.base import create_scorer, score_dataset
    from ranklib_tpu.models.gbdt import MART, LambdaMART
    from ranklib_tpu.utils.logging import set_silent
    from tools import oracle as orc

    if args.train:
        train = read_letor(args.train)
        test = read_letor(args.test) if args.test else None
    else:
        from tests.fixtures import synth_dataset
        print("no --train given: using a synthetic LETOR fixture",
              file=sys.stderr)
        train = synth_dataset(n_queries=16, n_features=8, min_docs=5,
                              max_docs=16, gmax=2, seed=42)
        test = synth_dataset(n_queries=8, n_features=8, min_docs=5,
                             max_docs=16, gmax=2, seed=43, w_seed=42)

    scorer = create_scorer(args.metric)
    cls = MART if args.ranker == 0 else LambdaMART
    hp = dict(n_trees=args.trees, n_leaves=args.leaves,
              learning_rate=args.shrinkage, n_threshold=args.tc)
    set_silent(True)
    eng = cls(**hp)
    eng.fit(train, scorer)

    o = orc.OracleLambdaMART(
        n_trees=args.trees, n_leaves=args.leaves,
        learning_rate=args.shrinkage, n_threshold=args.tc,
        metric=scorer.metric, k=scorer.k if scorer.uses_k else 0,
        gmax=scorer.gmax, pointwise=(cls is MART), newton=(cls is LambdaMART))
    o.fit(orc.dataset_to_oracle(train))

    ok = True
    n_e, n_o = len(eng.ensemble.trees), len(o.trees)
    print(f"trees: engine={n_e} oracle={n_o} "
          f"[{'OK' if n_e == n_o else 'DIVERGED'}]")
    ok &= n_e == n_o
    struct_ok = all(
        int(te.feature[s]) == to.nodes[s].feature
        and bool(te.is_leaf[s]) == to.nodes[s].is_leaf
        for te, to in zip(eng.ensemble.trees, o.trees)
        for s in range(te.n_slots) if not to.nodes[s].is_leaf)
    print(f"tree structures (split features, slot-for-slot): "
          f"[{'OK' if struct_ok else 'DIVERGED'}]")
    ok &= struct_ok

    for name, ds in (("training", train), ("test", test)):
        if ds is None:
            continue
        eng_scores = eng.eval_dataset(ds)
        orc_scores = [o.predict_query(q) for q in orc.dataset_to_oracle(ds)]
        worst = max(float(np.max(np.abs(np.asarray(a) - b)))
                    for a, b in zip(eng_scores, orc_scores))
        s_ok = worst <= TOL_SCORE
        print(f"per-doc scores on {name}: max |Δ|={worst:.2e} "
              f"[{'OK' if s_ok else 'DIVERGED'}]")
        ok &= s_ok
        m_e = score_dataset(scorer, ds, eng_scores)[0]
        m_o = o._dataset_metric(orc.dataset_to_oracle(ds), orc_scores)
        m_ok = abs(m_e - m_o) <= TOL_METRIC
        print(f"{scorer.name} on {name}: engine={m_e:.4f} oracle={m_o:.4f} "
              f"Δ={abs(m_e - m_o):.4f} [{'OK' if m_ok else 'DIVERGED'}]")
        ok &= m_ok
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jar", help="RankLib jar (omit with --oracle)")
    ap.add_argument("--oracle", action="store_true",
                    help="compare against the in-repo pure-numpy f64 "
                         "reference oracle instead of the Java jar")
    ap.add_argument("--train")
    ap.add_argument("--test")
    ap.add_argument("--ranker", type=int, default=6)
    ap.add_argument("--metric", default="NDCG@10")
    ap.add_argument("--trees", type=int, default=10,
                    help="[--oracle] boosting rounds (oracle is O(Q·D³)/round)")
    ap.add_argument("--leaves", type=int, default=4)
    ap.add_argument("--shrinkage", type=float, default=0.1)
    ap.add_argument("--tc", type=int, default=32)
    ap.add_argument("--extra", nargs="*", default=[],
                    help="extra flags passed to BOTH CLIs (e.g. -tree 100)")
    args = ap.parse_args()

    if args.oracle:
        return run_oracle_mode(args)
    if not args.jar or not args.train or not args.test:
        print("SKIP: --jar/--train/--test required without --oracle",
              file=sys.stderr)
        return 2
    if shutil.which("java") is None:
        print("SKIP: no java binary on PATH", file=sys.stderr)
        return 2
    if not Path(args.jar).exists():
        print(f"SKIP: jar not found: {args.jar}", file=sys.stderr)
        return 2

    tmp = Path(tempfile.mkdtemp(prefix="parity_"))
    ours_cli = [sys.executable, "-m", "ranklib_tpu"]
    java_cli = ["java", "-jar", args.jar]
    common = ["-train", args.train, "-test", args.test,
              "-ranker", str(args.ranker), "-metric2t", args.metric,
              *args.extra]

    ours = _run(ours_cli + common + ["-save", str(tmp / "ours.txt")])
    java = _run(java_cli + common + ["-save", str(tmp / "java.txt")])

    ok = True
    for which in ("training", "test"):
        a = _metric_from_output(ours, which)
        b = _metric_from_output(java, which)
        status = "OK" if abs(a - b) <= TOL_METRIC else "DIVERGED"
        ok &= status == "OK"
        print(f"{args.metric} on {which}: ours={a:.4f} java={b:.4f} "
              f"Δ={abs(a - b):.4f} [{status}]")

    # cross-load BOTH directions: each side's model scored by both CLIs
    for model, tag in (("java.txt", "java model"), ("ours.txt", "our model")):
        s_ours = _scores(ours_cli, str(tmp / model), args.test,
                         str(tmp / f"o_{model}"))
        s_java = _scores(java_cli, str(tmp / model), args.test,
                         str(tmp / f"j_{model}"))
        worst = max((abs(a - b) for a, b in zip(s_ours, s_java)),
                    default=0.0)
        status = "OK" if worst <= TOL_SCORE else "DIVERGED"
        ok &= status == "OK"
        print(f"cross-load ({tag}, ours vs java scores): "
              f"max |Δ|={worst:.2e} [{status}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
