"""Histogram-GBDT engine (the array-program core for MART / LambdaMART / RF).

The reference's tree machinery (learning/tree/{FeatureHistogram,
RegressionTree,Split,Ensemble}.java) dissolves into array programs here:

* :mod:`binning`    — feature threshold candidates + integer bin matrix
  (ref: FeatureHistogram thresholds, learning/tree/FeatureHistogram.java:~60);
* :mod:`grow`       — one fully-jitted leaf-wise tree grower over static
  node arrays (ref: RegressionTree.fit best-first loop,
  learning/tree/RegressionTree.java:~60);
* :mod:`lambdas`    — batched pairwise lambda/weight statistics
  (ref: LambdaMART.computePseudoResponses, learning/tree/LambdaMART.java:~300);
* :mod:`ensemble`   — flat tree arrays, vectorized traversal, and the
  RankLib ``<ensemble>`` XML text format
  (ref: learning/tree/Ensemble.java:~100).
"""
