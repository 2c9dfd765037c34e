"""Masked (Σ w·grad, Σ w) feature histograms — the boosting hot loop.

The reference builds these per node, threaded over features
(FeatureHistogram construct/update, learning/tree/FeatureHistogram.java:~200,
MyThreadPool). Here one segment-sum per node pass, on every platform.

Inside the jitted round step XLA hoists the loop-invariant bin-id
arithmetic out of the growth loop and fuses the masked broadcast into
the scatter, which beat a hand-written Triton kernel end to end on the
H100 (see PERF.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def hist_xla(binned_T, grad, mask, n_bins: int):
    """[F, B, 2] (Σ w·grad, Σ w) by one segment-sum.

    Bins upcast to i32 FIRST: with uint8 storage, ``binned < B`` at
    B = 256 would cast the weak literal INTO uint8 (wrapping to 0) and
    silently zero the keep mask — the device-storage-narrowing footgun
    (found by test_mart_learns when uint8 bins landed)."""
    F, N = binned_T.shape
    B = int(n_bins)
    binned = binned_T.T.astype(jnp.int32)
    ids = (jnp.arange(F, dtype=jnp.int32)[None, :] * B
           + jnp.minimum(binned, B - 1)).reshape(-1)
    keep = (binned < B).reshape(-1)
    m = mask.astype(jnp.float32)          # bool mask or f32 doc weights
    g = grad * m
    data = jnp.stack(
        [jnp.broadcast_to(g[:, None], (N, F)).reshape(-1),
         jnp.broadcast_to(m[:, None], (N, F)).reshape(-1)], axis=-1)
    data = jnp.where(keep[:, None], data, 0.0)
    h = jax.ops.segment_sum(data, ids, num_segments=F * B)
    return h.reshape(F, B, 2)


def hist_multi_xla(binned_T, grads, weights, n_bins: int):
    """[C, F, B, 2] batched (C-bag) histogram: sequential scan of the
    2-channel segment-sum over bags (lax.map bounds the [N·F] temporary to
    one bag's worth — a vmap would materialize all C at once)."""

    def one(gw):
        g, w = gw
        return hist_xla(binned_T, g, w, n_bins)

    return jax.lax.map(one, (grads, weights.astype(jnp.float32)))
