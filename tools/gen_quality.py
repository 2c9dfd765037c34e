"""Mechanical quality gate: all ten rankers on the MSLR-statistics-shaped
fixture.

Runs every ranker at fixed CPU-scale configs on `tests.fixtures.
mslr_like_dataset` (WEB10K label skew, doc-count tail, family-correlated
features) and writes the measured train/test NDCG@10 to QUALITY.json.
`tests/test_quality_gate.py` re-runs the same configs in CI and fails
loudly if any ranker drifts outside the committed band — quality numbers
reproduce mechanically instead of living in a hand-edited table.

Regenerate after an intentional quality-affecting change:

    JAX_PLATFORMS=cpu python tools/gen_quality.py

and commit the updated QUALITY.json.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

# One fixed fixture for the whole gate (≈7K docs train, ≈3.5K test).
FIXTURE = dict(train=dict(n_queries=60, seed=101, mean_docs=60.0),
               test=dict(n_queries=30, seed=102, w_seed=101,
                         mean_docs=60.0))
METRIC = "NDCG@10"
# Band half-width for the CI assert. The CPU fixture runs are fully
# deterministic (two fresh-process gate runs measured ZERO drift on all
# ten rankers, 2026-08-21), so the band only absorbs future
# compiler/library-version drift; 0.005 aligns with the ±0.002
# north-star tolerance while still failing loudly on a 0.01 regression
# (round-5 fix: was 0.02, 10× looser than the notes claimed).
TOLERANCE = 0.005

# (name, ranker builder) — CPU-scale configs, documented here so the CI
# re-run matches byte-for-byte.
def ranker_configs():
    from ranklib_tpu.models.adarank import AdaRank
    from ranklib_tpu.models.coorascent import CoorAscent
    from ranklib_tpu.models.gbdt import MART, LambdaMART
    from ranklib_tpu.models.linear import LinearRegRank
    from ranklib_tpu.models.neural import LambdaRank, ListNet, RankNet
    from ranklib_tpu.models.rankboost import RankBoost
    from ranklib_tpu.models.rf import RFRanker

    return [
        ("MART", lambda: MART(n_trees=30, n_leaves=6, learning_rate=0.1)),
        ("RankNet", lambda: RankNet(n_epoch=20, learning_rate=5e-5)),
        ("RankBoost", lambda: RankBoost(n_rounds=50, n_threshold=10)),
        ("AdaRank", lambda: AdaRank(n_rounds=50)),
        ("CoorAscent", lambda: CoorAscent(n_restart=1, max_passes=5)),
        ("LambdaRank", lambda: LambdaRank(n_epoch=20, learning_rate=5e-5)),
        ("LambdaMART", lambda: LambdaMART(n_trees=50, n_leaves=6,
                                          learning_rate=0.1)),
        ("ListNet", lambda: ListNet(n_epoch=100, learning_rate=1e-2)),
        ("RF", lambda: RFRanker(n_bags=8, n_trees=1, n_leaves=30)),
        ("Linear", lambda: LinearRegRank()),
    ]


# Neural rankers get per-query zscore normalization (`-norm zscore`), the
# standard RankLib usage on raw web features — MSLR-like features are
# heavy-tailed (TF counts into the tens of thousands) and saturate an
# unnormalized sigmoid net, which is a property of the config, not a bug.
_NORMALIZED = {"RankNet", "LambdaRank", "ListNet"}


_FIXTURE_CACHE = {}


def _gate_data():
    """Build (and memoize — the CI gate calls run_gate per ranker) the
    raw and zscore-normalized fixture pairs."""
    from ranklib_tpu.data.normalize import normalize_dataset
    from tests.fixtures import mslr_like_dataset

    if "data" not in _FIXTURE_CACHE:
        train = mslr_like_dataset(**FIXTURE["train"])
        test = mslr_like_dataset(**FIXTURE["test"])
        train_n = mslr_like_dataset(**FIXTURE["train"])
        test_n = mslr_like_dataset(**FIXTURE["test"])
        normalize_dataset(train_n, "zscore")
        normalize_dataset(test_n, "zscore")
        _FIXTURE_CACHE["data"] = (train, test, train_n, test_n)
    return _FIXTURE_CACHE["data"]


def run_gate(subset: list | None = None) -> dict:
    from ranklib_tpu.metrics.base import create_scorer
    from ranklib_tpu.utils.logging import set_silent

    set_silent(True)
    train, test, train_n, test_n = _gate_data()
    scorer = create_scorer(METRIC)
    out = {}
    for name, build in ranker_configs():
        if subset and name not in subset:
            continue
        tr, te = ((train_n, test_n) if name in _NORMALIZED
                  else (train, test))
        t0 = time.perf_counter()
        r = build()
        r.fit(tr, scorer)
        out[name] = {
            "train": round(r.score_metric(tr, scorer), 4),
            "test": round(r.score_metric(te, scorer), 4),
            "wall_s": round(time.perf_counter() - t0, 1),
        }
        print(f"{name:<12} train={out[name]['train']:.4f} "
              f"test={out[name]['test']:.4f} "
              f"({out[name]['wall_s']}s)", flush=True)
    return out


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    rankers = run_gate()
    doc = {"fixture": FIXTURE, "metric": METRIC, "tolerance": TOLERANCE,
           "rankers": rankers}
    (REPO / "QUALITY.json").write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {REPO / 'QUALITY.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
