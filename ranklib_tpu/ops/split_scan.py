"""Best-split scan over node histograms.

The cumsum → gain → argmax chain of the reference's findBestSplit
(learning/tree/FeatureHistogram.java:~300), over all candidate nodes at
once: the split maximizing S_L²/c_L + S_R²/c_R among (feature, bin)
candidates with both sides ≥ minLeafSupport, first (feature-major) max
on ties. XLA fuses the chain into a few kernels on the GPU.
"""

from __future__ import annotations

import jax.numpy as jnp


def best_splits(hist, mls: float, fmask=None):
    """hist [Cn, F, B, 2] → (gain [Cn], feature [Cn], bin [Cn], ok [Cn]).
    Totals derive from each row's own bin sum (every feature bins every
    doc exactly once)."""
    # -mls 0 must still reject EMPTY sides: the reference's 0/0 division
    # yields NaN and such candidates never win, while a 0-count side here
    # would score s²/max(c,1) = the parent term and could tie-win the
    # first-max scan (review finding) — floor the support test above 0
    mls = max(float(mls), 1e-9)
    c_l = jnp.cumsum(hist[..., 1], axis=2)
    s_l = jnp.cumsum(hist[..., 0], axis=2)
    c_r = c_l[..., -1:] - c_l
    s_r = s_l[..., -1:] - s_l
    ok = (c_l >= mls) & (c_r >= mls)
    if fmask is not None:
        ok = ok & fmask[:, :, None]
    gain = jnp.where(
        ok,
        s_l * s_l / jnp.maximum(c_l, 1.0) + s_r * s_r / jnp.maximum(c_r, 1.0),
        -jnp.inf)
    Cn, F, B = gain.shape
    flat = gain.reshape(Cn, F * B)
    idx = jnp.argmax(flat, axis=1)
    g = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
    return (g, (idx // B).astype(jnp.int32), (idx % B).astype(jnp.int32),
            jnp.isfinite(g))
