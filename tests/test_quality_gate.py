"""Mechanical quality gate.

Re-runs every ranker config from tools/gen_quality.py on the
MSLR-statistics-shaped fixture and asserts each train/test NDCG@10 stays
inside the committed band in QUALITY.json. A quality regression in any
ranker fails THIS test loudly instead of silently aging a hand-edited
QUALITY.md table. After an intentional quality-affecting change,
regenerate with `JAX_PLATFORMS=cpu python tools/gen_quality.py`
and commit the new QUALITY.json.
"""

import json
from pathlib import Path

import pytest

from tools.gen_quality import run_gate, ranker_configs

QUALITY = json.loads(
    (Path(__file__).resolve().parent.parent / "QUALITY.json").read_text())


@pytest.mark.parametrize("name", [n for n, _ in ranker_configs()])
def test_quality_band(name):
    recorded = QUALITY["rankers"].get(name)
    assert recorded is not None, (
        f"{name} missing from QUALITY.json — regenerate with "
        "tools/gen_quality.py")
    got = run_gate(subset=[name])[name]
    tol = QUALITY["tolerance"]
    for split in ("train", "test"):
        assert abs(got[split] - recorded[split]) <= tol, (
            f"{name} {split} NDCG@10 drifted: measured {got[split]:.4f}, "
            f"committed {recorded[split]:.4f} ± {tol}")
