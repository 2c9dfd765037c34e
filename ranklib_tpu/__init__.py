"""ranklib_tpu — an accelerator-native learning-to-rank engine (JAX, GPU).

A from-scratch JAX/XLA/Pallas framework with the full capability surface of
RankLib (reference: codelibs/ranklib, surveyed in SURVEY.md):

* ten rankers — MART, RankNet, RankBoost, AdaRank, Coordinate Ascent,
  LambdaRank, LambdaMART, ListNet, Random Forests, Linear Regression —
  addressable by the reference's ``-ranker 0..9`` integers
  (ref: learning/RankerType.java:~10);
* LETOR/SVMLight feature files grouped by query
  (ref: learning/DataPoint.java:~120, features/FeatureManager.java:~60);
* metrics MAP/NDCG@k/DCG@k/P@k/RR@k/ERR@k/Best@k with swap-delta matrices
  (ref: metric/*Scorer.java);
* RankLib-compatible CLI semantics and interoperable text model files
  (ref: eval/Evaluator.java:~70).

It is NOT a Java port: tree boosting is reformulated as vectorized histogram
building (one-hot matmuls on the tensor cores), batched |ΔNDCG|-weighted
lambda programs, and on-device split search; neural rankers are jitted
JAX loops; query groups shard data-parallel over a jax.sharding.Mesh
with psum'd histogram/gradient statistics.
"""

__version__ = "0.1.0"

from ranklib_tpu.models.base import RANKER_NAMES, get_ranker_class  # noqa: F401
