"""RankLib-compatible command line (ref: eval/Evaluator.java:~100-350).

Published RankLib command lines run verbatim, e.g.::

    python -m ranklib_tpu -train MQ2008/Fold1/train.txt -ranker 6 \
        -metric2t NDCG@10 -test MQ2008/Fold1/test.txt -save model.txt

The reference uses a hand-rolled argv loop with single-dash long flags;
argparse reproduces that surface. Hyperparameter flags are forwarded to the
ranker only when explicitly given, so per-ranker defaults live in the
ranker classes (the reference's defaults, SURVEY.md §2 L3 table).
"""

from __future__ import annotations

import argparse
import sys

from ranklib_tpu.utils.errors import RankLibError
from ranklib_tpu.utils.logging import log, set_silent


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ranklib_tpu", add_help=True, allow_abbrev=False,
        description="Accelerator-native learning-to-rank engine "
                    "(RankLib-compatible CLI)")
    # training flows
    p.add_argument("-train", metavar="file")
    p.add_argument("-ranker", type=int, default=4,
                   help="0:MART 1:RankNet 2:RankBoost 3:AdaRank 4:CoorAscent "
                        "5:LambdaRank 6:LambdaMART 7:ListNet 8:RandomForests "
                        "9:LinearRegression (default 4)")
    p.add_argument("-feature", metavar="file")
    p.add_argument("-metric2t", default="ERR@10",
                   help="train metric (default ERR@10)")
    p.add_argument("-metric2T", default=None, help="test metric")
    p.add_argument("-gmax", type=float, default=4.0)
    p.add_argument("-qrel", metavar="file")
    p.add_argument("-missingZero", action="store_true")
    p.add_argument("-validate", metavar="file")
    p.add_argument("-tvs", type=float, default=-1.0)
    p.add_argument("-tts", type=float, default=-1.0,
                   help="train-test split ratio x: first x of the training "
                        "queries train, the rest test (overrides -tvs and "
                        "an explicit -test file, like the reference)")
    p.add_argument("-test", metavar="file")
    p.add_argument("-norm", choices=["sum", "zscore", "linear"])
    p.add_argument("-sparse", action="store_true",
                   help="memory-lean input for wide/sparse data: tree "
                        "rankers stream straight into the int16 bin "
                        "matrix; neural/RankBoost/AdaRank/CoorAscent/"
                        "linear land in host CSR with bounded dense "
                        "chunks (neither path ever materializes the full "
                        "dense float matrix; -norm applies lazily at "
                        "materialization — tree rankers then bin from "
                        "normalized chunks); only -qrel falls back to "
                        "the dense pipeline")
    p.add_argument("-save", metavar="file")
    p.add_argument("-kcv", type=int, default=-1)
    p.add_argument("-kcvmd", metavar="dir")
    p.add_argument("-kcvmn", metavar="name")
    # test / rerank flows
    p.add_argument("-load", metavar="file")
    p.add_argument("-idv", metavar="file")
    p.add_argument("-rank", metavar="file")
    p.add_argument("-score", metavar="file")
    p.add_argument("-indri", metavar="file")
    # misc
    p.add_argument("-silent", action="store_true")
    p.add_argument("-thread", type=int, default=-1,
                   help="accepted for compatibility; parallelism is XLA's")
    p.add_argument("-ckpt", type=int, default=None,
                   help="checkpoint the model every N boosting rounds "
                        "(extension; tree rankers)")
    p.add_argument("-resume", metavar="file",
                   help="warm-start tree training from a saved model "
                        "(extension; continues toward -tree total)")
    p.add_argument("-dp", type=int, default=0,
                   help="data-parallel devices for tree-ranker training "
                        "(extension; 0 = single device). Queries shard over "
                        "a mesh with psum'd histogram statistics")
    p.add_argument("-randomSeed", type=int, default=0)
    p.add_argument("-eventlog", metavar="file",
                   help="structured JSONL event log (extension over RankLib)")
    p.add_argument("-profile", metavar="dir",
                   help="write a jax.profiler trace of training to DIR "
                        "(extension; view with TensorBoard)")
    # ranker hyperparameters (None = use ranker default)
    p.add_argument("-epoch", type=int)
    p.add_argument("-layer", type=int)
    p.add_argument("-node", type=int)
    p.add_argument("-lr", type=float)
    p.add_argument("-tree", type=int)
    p.add_argument("-leaf", type=int)
    p.add_argument("-shrinkage", type=float)
    p.add_argument("-tc", type=int)
    p.add_argument("-mls", type=int)
    p.add_argument("-estop", type=int)
    p.add_argument("-round", type=int)
    p.add_argument("-noeq", action="store_true", default=None)
    p.add_argument("-tolerance", type=float)
    p.add_argument("-max", type=int)
    p.add_argument("-r", type=int)
    p.add_argument("-i", type=int)
    p.add_argument("-reg", type=float)
    p.add_argument("-bag", type=int)
    p.add_argument("-srate", type=float)
    p.add_argument("-frate", type=float)
    p.add_argument("-rtype", type=int)
    p.add_argument("-L2", type=float, dest="l2")
    # analyzer mode (ref: eval/Analyzer.java)
    p.add_argument("-ana", action="store_true")
    p.add_argument("-all", metavar="dir")
    p.add_argument("-base", metavar="file")
    p.add_argument("-np", type=int, default=10000, dest="n_permutations")
    # combiner mode (ref: learning/Combiner.java)
    p.add_argument("-combine", metavar="dir")
    p.add_argument("-o", metavar="file", dest="combine_out")
    return p


# (cli flag, ranker id set, attribute name) — per-ranker hyperparam routing
_HPARAM_ROUTES = [
    ("epoch", {1, 5, 7}, "n_epoch"),
    ("layer", {1, 5}, "n_layers"),
    ("node", {1, 5}, "n_hidden_per_layer"),
    ("lr", {1, 5, 7}, "learning_rate"),
    ("tree", {0, 6, 8}, "n_trees"),
    ("leaf", {0, 6, 8}, "n_leaves"),
    ("shrinkage", {0, 6, 8}, "learning_rate"),
    ("tc", {0, 6, 8}, "n_threshold"),
    ("tc", {2}, "n_threshold"),
    ("ckpt", {0, 6}, "ckpt_every"),
    ("mls", {0, 6, 8}, "min_leaf_support"),
    ("estop", {0, 6}, "early_stop"),
    ("round", {2, 3}, "n_rounds"),
    ("noeq", {3}, "no_eq"),
    ("tolerance", {3, 4}, "tolerance"),
    ("max", {3}, "max_sel_count"),
    ("r", {4}, "n_restart"),
    ("i", {4}, "n_max_iteration"),
    ("reg", {4}, "reg"),
    ("bag", {8}, "n_bags"),
    ("srate", {8}, "sub_sampling_rate"),
    ("frate", {8}, "feature_sampling_rate"),
    ("rtype", {8}, "ranker_type"),
    ("l2", {9}, "lam"),
]


def collect_hparams(args) -> dict:
    hp = {}
    for flag, rankers, attr in _HPARAM_ROUTES:
        v = getattr(args, flag, None)
        if v is not None and args.ranker in rankers:
            hp[attr] = v
    if hp.get("ckpt_every"):
        hp["ckpt_path"] = (args.save + ".ckpt") if args.save else "model.ckpt"
    if getattr(args, "resume", None) and args.ranker in (0, 6):
        hp["_resume_from"] = args.resume
    if args.randomSeed and args.ranker in (1, 4, 5, 7, 8):
        hp.setdefault("seed", args.randomSeed)
    return hp


def _ensure_backend() -> None:
    """Prepare JAX before any computation: enable the compile cache.

    The platform is JAX's own choice; ``JAX_PLATFORMS`` selects one
    (``cpu``, ``cuda``). A selected platform that fails to start fails
    the run — nothing falls back to another device.
    """
    from ranklib_tpu.utils.compile_cache import enable_compilation_cache

    enable_compilation_cache()


_NOTHING_TO_DO = ("Nothing to do: give -train, -load -test, -load -rank, "
                  "-ana, or -combine")


def _has_flow(args) -> bool:
    """True when the arguments select one of the dispatchable flows —
    the SAME condition the dispatch chain in main() walks, kept in one
    place so the pre-backend gate and the chain cannot disagree."""
    return bool(args.ana or args.combine or args.train
                or (args.load and (args.rank or args.test)))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    set_silent(args.silent)
    # decide the flow BEFORE initializing the backend: nothing-to-do /
    # bad-argument errors must not wait on device discovery
    if not _has_flow(args):
        log(f"Error: {_NOTHING_TO_DO}")
        return 1
    _ensure_backend()
    if args.eventlog:
        from ranklib_tpu.utils.logging import set_event_log
        set_event_log(args.eventlog)
    args.hparams = collect_hparams(args)
    try:
        if args.ana:
            from ranklib_tpu.analyzer import analyze
            if not args.all or not args.base:
                raise RankLibError("-ana requires -all <dir> and -base <file>")
            analyze(args.all, args.base, args.n_permutations)
        elif args.combine:
            from ranklib_tpu.combiner import combine
            if not args.combine_out:
                raise RankLibError("-combine requires -o <output model file>")
            combine(args.combine, args.combine_out)
        elif args.train and args.kcv > 0:
            from ranklib_tpu.evaluator import evaluate_kcv
            evaluate_kcv(args)
        elif args.train:
            from ranklib_tpu.evaluator import evaluate_train
            evaluate_train(args)
        elif args.load and args.rank:
            from ranklib_tpu.evaluator import evaluate_rank
            evaluate_rank(args)
        elif args.load and args.test:
            from ranklib_tpu.evaluator import evaluate_test_only
            evaluate_test_only(args)
        else:                          # unreachable: _has_flow gated above
            raise RankLibError(_NOTHING_TO_DO)
    except RankLibError as e:
        log(f"Error: {e}")
        return 1
    except OSError as e:
        log(f"Error: {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
