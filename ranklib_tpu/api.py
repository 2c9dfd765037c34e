"""Programmatic API — the library face of the RankLib-compatible CLI.

The CLI (`python -m ranklib_tpu …`) is the reference's external contract
(eval/Evaluator.java); this module is the supported way to do the same
things from Python without touching internal modules::

    import ranklib_tpu.api as rl

    train = rl.read("train.txt")
    test = rl.read("test.txt")
    model = rl.train(train, ranker=6, metric="NDCG@10", n_trees=300)
    print(rl.evaluate(model, test, metric="NDCG@10"))   # macro-averaged
    rl.save(model, "model.txt")                         # RankLib text format

    model = rl.load("model.txt")
    ranked = rl.rank(model, test)        # per-query doc orderings
    scores = rl.score(model, test)       # per-query score arrays

Ranker selection accepts the reference's ``-ranker`` integers (0–9) or
display names ("LambdaMART"); hyperparameters are the ranker attributes
(``n_trees``, ``n_leaves``, ``learning_rate``, …) rather than CLI flags.
"""

from __future__ import annotations

import numpy as np

from ranklib_tpu.data.dataset import Dataset
from ranklib_tpu.data.letor import read_letor
from ranklib_tpu.metrics.base import create_scorer, score_dataset
from ranklib_tpu.models.base import Ranker, load_ranker_file
from ranklib_tpu.models.trainer import train_ranker

__all__ = ["read", "train", "evaluate", "rank", "score", "save", "load",
           "Dataset", "Ranker"]

_backend_ready = False


def _ensure_backend() -> None:
    """The CLI's JAX preparation (compile cache) for library users. Runs
    once, before the first compute-touching API call."""
    global _backend_ready
    if _backend_ready:
        return
    from ranklib_tpu.cli import _ensure_backend as _cli_ensure

    _cli_ensure()
    _backend_ready = True


def read(path: str, must_have_rel_doc: bool = False,
         n_features: int | None = None, sparse: bool = False,
         descs: bool = False) -> Dataset:
    """Read a LETOR/SVMLight file (gzip ok) into a Dataset.

    ``sparse=True`` lands the file in host CSR (memory ~ nnz; the CLI's
    ``-sparse`` storage for raw-value rankers) — dense blocks materialize
    on demand in bounded chunks, trained models are bit-identical.
    ``descs=True`` additionally keeps the per-doc '#' descriptions on a
    sparse read (needed for qrel docid matching / indri output; the
    dense reader always keeps them)."""
    if sparse:
        from ranklib_tpu.data.sparse import read_letor_sparse

        return read_letor_sparse(path, must_have_rel_doc=must_have_rel_doc,
                                 n_features=n_features, quiet=True,
                                 want_descs=descs)
    return read_letor(path, must_have_rel_doc=must_have_rel_doc,
                      n_features=n_features, quiet=True)


def train(data: Dataset | str, ranker=6, metric: str = "NDCG@10",
          validation: Dataset | str | None = None, gmax: float = 4.0,
          n_dp: int = 0, **hyperparams) -> Ranker:
    """Train a ranker; ``ranker`` is a ``-ranker`` integer or display name
    (resolved like the CLI/model-file dispatcher — unknown values raise
    RankLibError).

    ``hyperparams`` are ranker attributes (e.g. ``n_trees=500``,
    ``learning_rate=0.05`` for LambdaMART). ``n_dp > 1`` = data-parallel
    training over that many devices (GBDT family). Path inputs follow the
    CLI's mustHaveRelDoc rule: when the train metric needs relevance
    (MAP/P/RR), queries with no relevant doc are dropped at read time
    (pre-built Datasets are used as given).
    """
    _ensure_backend()
    scorer = create_scorer(metric, gmax=gmax)
    if isinstance(data, str):
        data = read(data, must_have_rel_doc=scorer.needs_rel)
    if isinstance(validation, str):
        validation = read(validation, must_have_rel_doc=scorer.needs_rel)
    return train_ranker(ranker, data, scorer, validation, hyperparams,
                        n_dp=n_dp)


def evaluate(model: Ranker, data: Dataset | str, metric: str = "NDCG@10",
             gmax: float = 4.0, per_query: bool = False):
    """Macro-averaged metric of the model on a dataset (ref: scoreAll).

    ``per_query=True`` also returns the [Q] per-query values (the numbers
    ``-idv`` writes)."""
    _ensure_backend()
    if isinstance(data, str):
        data = read(data)
    scorer = create_scorer(metric, gmax=gmax)
    mean, pq = score_dataset(scorer, data, model.eval_dataset(data))
    return (mean, pq) if per_query else mean


def score(model: Ranker, data: Dataset | str) -> list[np.ndarray]:
    """Per-query score arrays, aligned with each query's doc order."""
    _ensure_backend()
    if isinstance(data, str):
        data = read(data)
    return [np.asarray(s) for s in model.eval_dataset(data)]


def rank(model: Ranker, data: Dataset | str) -> list[np.ndarray]:
    """Per-query doc permutations, best first (stable ties — the
    reference's MergeSorter contract)."""
    _ensure_backend()
    if isinstance(data, str):
        data = read(data)
    out = []
    for s in model.eval_dataset(data):
        out.append(np.argsort(-np.asarray(s), kind="stable"))
    return out


def save(model: Ranker, path: str) -> None:
    """Write the RankLib text model format (`## <Name>` header)."""
    model.save(path)


def load(path: str) -> Ranker:
    """Load any RankLib-format model file (header line dispatches)."""
    return load_ranker_file(path)
