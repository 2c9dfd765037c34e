"""The Ranker contract and factory.

The reference's only polymorphism seam is the abstract Ranker class
(ref: learning/Ranker.java:~40): every algorithm implements
init/learn/eval/rank/save/load/model/name, and the Evaluator addresses
algorithms by `-ranker N` integer (ref: learning/RankerType.java:~10) or by
display name (ref: learning/RankerFactory.java:~30). Those integers and the
``## <Name>`` model-file header line are API surface and preserved exactly.

Design departures from the reference (array-first):

* hyperparameters are per-instance dataclass-style attributes, not mutable
  class statics (the reference sets public static fields before
  construction — global state we deliberately drop);
* ``fit`` consumes a whole Dataset and runs jitted batched loops;
* ``eval_dataset`` returns per-query score arrays in one batched pass
  instead of per-DataPoint virtual calls.
"""

from __future__ import annotations

import numpy as np

from ranklib_tpu.data.dataset import Dataset
from ranklib_tpu.metrics.base import MetricScorer, score_dataset
from ranklib_tpu.utils.errors import RankLibError
from ranklib_tpu.utils.logging import log

# -ranker N → canonical display name (ref: RankerType enum, CLI order)
RANKER_NAMES = {
    0: "MART",
    1: "RankNet",
    2: "RankBoost",
    3: "AdaRank",
    4: "Coordinate Ascent",
    5: "LambdaRank",
    6: "LambdaMART",
    7: "ListNet",
    8: "Random Forests",
    9: "Linear Regression",
}

_REGISTRY = {}  # display name -> class


def register_ranker(cls):
    """Class decorator: register under cls.NAME."""
    _REGISTRY[cls.NAME] = cls
    return cls


def get_ranker_class(ranker):
    """Resolve a `-ranker N` integer or display name to a class."""
    # Import submodules lazily so the registry is populated on first use.
    from ranklib_tpu.models import (  # noqa: F401
        adarank, coorascent, gbdt, linear, neural, rankboost, rf,
    )

    if isinstance(ranker, int):
        try:
            name = RANKER_NAMES[ranker]
        except KeyError:
            raise RankLibError(f"Unknown ranker id {ranker} (expected 0..9)") from None
    else:
        name = str(ranker)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise RankLibError(f"Unknown ranker '{name}'") from None


class Ranker:
    """Base class: the 8-method contract of the reference's Ranker."""

    NAME = "?"

    def __init__(self, **hparams):
        for k, v in hparams.items():
            if not hasattr(self, k):
                raise RankLibError(f"{self.NAME}: unknown hyperparameter '{k}'")
            setattr(self, k, v)

    # ---- training --------------------------------------------------------
    def fit(self, train: Dataset, scorer: MetricScorer,
            validation: Dataset | None = None) -> None:
        raise NotImplementedError

    # ---- scoring -----------------------------------------------------------
    def eval_dataset(self, ds: Dataset) -> list:
        """Per-query score arrays (list aligned with ds.queries)."""
        raise NotImplementedError

    def rank_dataset(self, ds: Dataset):
        """Per-query permutations sorting docs by score desc (stable —
        ref: Ranker.rank uses MergeSorter)."""
        return [
            np.argsort(-s, kind="stable") for s in self.eval_dataset(ds)
        ]

    def score_metric(self, ds: Dataset, scorer: MetricScorer) -> float:
        return score_dataset(scorer, ds, self.eval_dataset(ds))[0]

    # ---- serialization -----------------------------------------------------
    def model_str(self) -> str:
        """Text model body, RankLib-interoperable where formats are known."""
        raise NotImplementedError

    def load_str(self, text: str) -> None:
        raise NotImplementedError

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.model_str())
        log(f"Model saved to: {path}")

    # ---- logging -----------------------------------------------------------
    def log_header(self, scorer: MetricScorer, has_validation: bool) -> None:
        log("Training starts...")


def load_ranker_file(path: str) -> Ranker:
    """Instantiate + load from a text model file; the first line
    ``## <Name>`` is the dispatcher (ref: RankerFactory.loadRankerFromFile,
    learning/RankerFactory.java:~90)."""
    with open(path) as f:
        text = f.read()
    first = text.split("\n", 1)[0].strip()
    if not first.startswith("## "):
        raise RankLibError(f"Model file {path} missing '## <Name>' header")
    name = first[3:].strip()
    cls = get_ranker_class(name)
    r = cls()
    r.load_str(text)
    return r


def model_header(name: str, params: dict) -> str:
    """'## <Name>' + '## key = value' comment lines (reference format)."""
    lines = [f"## {name}"]
    for k, v in params.items():
        lines.append(f"## {k} = {v}")
    return "\n".join(lines) + "\n"


def parse_model_params(text: str):
    """Parse '## key = value' comment lines; returns (params, body_lines)."""
    params = {}
    body = []
    for line in text.splitlines():
        if line.startswith("##"):
            inner = line[2:].strip()
            if "=" in inner:
                k, _, v = inner.partition("=")
                params[k.strip()] = v.strip()
        elif line.strip():
            body.append(line)
    return params, body
