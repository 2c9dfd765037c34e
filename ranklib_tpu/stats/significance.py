"""Significance testing (ref: stats/RandomPermutationTest.java:~15,
stats/SignificanceTest.java, stats/BasicStats.java).

Two-sided Fisher randomization test over per-query paired differences:
the observed statistic is the mean difference; under the null each
query's difference is equally likely to carry either sign, so the
reference sign-flips the per-query deltas (default 10,000 permutations)
and reports the fraction of permuted |mean| ≥ observed |mean|.

Array shape: all permutations at once — random ±1 matrix [P, Q] times
deltas [Q] is ONE matmul; the reference's 10k-iteration scalar
loop disappears.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ranklib_tpu.utils.errors import RankLibError


def randomization_test(base: np.ndarray, target: np.ndarray,
                       n_permutations: int = 10_000, seed: int = 0) -> float:
    """p-value for the paired difference target − base (two-sided)."""
    base = np.asarray(base, np.float64)
    target = np.asarray(target, np.float64)
    if base.shape != target.shape or base.ndim != 1:
        raise ValueError("randomization_test needs two equal-length vectors")
    if n_permutations <= 0:
        raise RankLibError(
            f"-np must be positive (got {n_permutations})")
    d = target - base
    q = d.shape[0]
    if q == 0:
        return 1.0
    observed = abs(float(d.mean()))
    # Tie tolerance: permutations whose |mean| EQUALS the observed value
    # (e.g. sign flips of all-zero deltas — the common mostly-tied -ana
    # case) must count as ≥. The permuted means come from an f32 matmul
    # whose summation order differs from the f64 np.mean above, so exact
    # equality is off by ~1e-7 relative — a 1e-12 slack silently dropped
    # or kept the WHOLE tie class at once (p error up to the tie mass).
    # Scale the slack to the f32 error of the statistic instead; genuine
    # near-misses within it are counted, which only errs conservative
    # (larger p).
    tol = 1e-5 * float(np.abs(d).mean()) + 1e-12
    key = jax.random.PRNGKey(seed)
    # chunk permutations to bound the [P, Q] sign matrix
    chunk = max(1, min(n_permutations, (1 << 22) // max(q, 1)))
    count = 0
    done = 0
    dj = jnp.asarray(d, jnp.float32)
    while done < n_permutations:
        p = min(chunk, n_permutations - done)
        key, sub = jax.random.split(key)
        count += int(_count_extreme(sub, dj, observed, tol, p))
        done += p
    return count / n_permutations


@partial(jax.jit, static_argnames=("p",))
def _count_extreme(key, d, observed, tol, p: int):
    signs = jax.random.rademacher(key, (p, d.shape[0]), dtype=jnp.float32)
    means = jnp.abs(signs @ d) / d.shape[0]
    return (means >= observed - tol).sum()


def basic_stats(values: np.ndarray) -> dict:
    v = np.asarray(values, np.float64)
    return {"mean": float(v.mean()), "std": float(v.std(ddof=1)) if len(v) > 1 else 0.0,
            "n": int(len(v))}
