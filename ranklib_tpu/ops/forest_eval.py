"""Fused ensemble scoring on the GPU: a Pallas kernel through Triton.

Scores docs as ``gbdt.ensemble._mm_eval`` does — predicate, path
agreement, leaf indicator, leaf fold (ref: learning/tree/Ensemble.java:~20,
eval = Σ w·tree(x)) — but keeps each doc tile's predicates on chip. The
XLA path writes the [T·M, N] predicate matrix to device memory and reads
it back for the path dot; here X is read once and nothing but the [N]
scores is written.

Per program (one tile of TN docs), for each tree chunk c:

    vals = X[docs, fid_c]                  gather, exact f32   [TN, Mp]
    pred = vals <= thr_c                   0/1 in bf16         (NaN → 0)
    hits = pred · pmq_c                    tensor-core dot     [TN, Lp]
    score += Σ_leaf [hits == nleft_c]·outw_c

``pmq_c`` holds +1 for a node a leaf's path leaves to the left, −1 for
one it leaves to the right; a doc reaches the leaf iff every left edge
tests true and no right edge does, i.e. iff ``hits`` equals the leaf's
left-edge count. pred, pmq and hits are small integers, exact in bf16
with f32 accumulation; the compare is the f32 compare of the traversal,
so the scores differ from ``_ensemble_eval`` only by the order of the f32
leaf sum. Chunks hold ``64 // max(M, L)`` trees, padded to power-of-two
widths; ``ops.routing`` sends trees wider than 128 nodes to ``_mm_eval``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_TN = 128              # docs per program
_WIDTH = 64            # target per-chunk node / leaf width


def _score_kernel(x_ref, fid_ref, thr_ref, pmq_ref, nleft_ref, outw_ref,
                  o_ref, *, n_docs: int, n_chunks: int):
    docs = pl.program_id(0) * _TN + jnp.arange(_TN)
    valid = docs < n_docs

    def chunk(c, acc):
        fid = fid_ref[c, :]
        vals = plgpu.load(x_ref.at[docs[:, None], fid[None, :]],
                          mask=valid[:, None], other=0.0)
        pred = (vals <= thr_ref[c, :][None, :]).astype(jnp.bfloat16)
        hits = jax.lax.dot(pred, pmq_ref[c],
                           preferred_element_type=jnp.float32)
        leaf = jnp.where(hits == nleft_ref[c, :][None, :],
                         outw_ref[c, :][None, :], 0.0)
        return acc + jnp.sum(leaf, axis=1)

    acc = jax.lax.fori_loop(0, n_chunks, chunk,
                            jnp.zeros((_TN,), jnp.float32))
    plgpu.store(o_ref.at[docs], acc, mask=valid)


@functools.partial(jax.jit, static_argnames=("interpret",))
def forest_eval_triton(X, fid, thr, pmq, nleft, outw,
                       interpret: bool = False):
    """X: [N, F] f32; the rest in the ``TreeEnsemble._pack_kernel``
    layout (fid/thr [nch, Mp], pmq [nch, Mp, Lp] bf16, nleft/outw
    [nch, Lp]). Returns scores [N] f32."""
    N = X.shape[0]
    return pl.pallas_call(
        functools.partial(_score_kernel, n_docs=N, n_chunks=fid.shape[0]),
        out_shape=jax.ShapeDtypeStruct((N,), jnp.float32),
        grid=(pl.cdiv(N, _TN),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="ranklib_forest_eval",
    )(X, fid, thr, pmq, nleft, outw)
