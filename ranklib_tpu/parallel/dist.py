"""Data-parallel training over a ``jax.sharding.Mesh``.

The reference's only parallelism is one intra-process thread pool
(utilities/MyThreadPool.java — threads partition query ranges in the
lambda phase and feature ranges in the histogram phase). The device
equivalent (SURVEY.md §2 last rows, §5 communication row):

* queries (and their docs) shard over a 1-D ``"batch"`` mesh axis — the
  lambda phase is embarrassingly parallel because every pair matrix is
  query-local;
* per-tree histogram and node statistics are all-reduced with ``psum``
  over the card links (NVLink within a host) — histograms are tiny
  (F × bins × 2 floats), which is why GBDT data-parallel scales;
* split decisions replicate deterministically on every device, so tree
  structure needs no further communication.

Multi-host: call ``jax.distributed.initialize()`` before building the
mesh; the same ``shard_map`` program then spans hosts, its collectives
handed to NCCL. The mesh is flat (1-D): every card reaches every other
at the same rate, so the layout follows the algorithm alone.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ranklib_tpu.gbdt.grow import TreeArrays, grow_tree, leaf_outputs
from ranklib_tpu.gbdt.lambdas import lambda_weights

AXIS = "batch"


def make_mesh(n_devices: int | None = None, axis: str = AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def make_train_step(scorer, n_bins: int, n_leaves: int,
                    min_leaf_support: int, learning_rate: float,
                    mesh: Mesh, axis: str = AXIS):
    """Build the jitted distributed LambdaMART round (SCAFFOLDING — the
    mechanism demo used by the multihost smoke and the scaling harness;
    the PRODUCT distributed path is gbdt.boost_dist, which additionally
    chunks pair work).

    Inputs (all sharded on the leading query axis over ``axis``):
      binned [B, D, F] int32, labels [B, D] f32, mask [B, D] bool,
      scores [B, D] f32.
    Returns (new_scores [B, D] sharded, TreeArrays with replicated node
    arrays and sharded node_of_doc, leaf outputs [2·nLeaves−1] replicated).

    CALLER CONTRACT: ``lambda_weights`` materializes the full [B, D, D]
    pair block per shard — keep B·D² under the ~64 MB pair budget (small
    smoke shapes). Real-scale training must go through gbdt.boost_dist,
    whose buckets are pre-chunked (review finding: this entry point does
    NOT chunk)."""
    M = 2 * n_leaves - 1

    def step(binned, labels, mask, scores):
        lam, w = lambda_weights(scorer, labels, scores, mask)
        B, D, F = binned.shape
        bnn = binned.reshape(B * D, F).T          # feature-major for grow
        g = lam.reshape(-1)
        ww = w.reshape(-1)
        dm = mask.reshape(-1)
        tree = grow_tree(bnn, g, n_bins=n_bins, n_leaves=n_leaves,
                         min_leaf_support=min_leaf_support, doc_mask=dm,
                         axis_name=axis)
        out = leaf_outputs(tree.node_of_doc, g, ww, M, newton=True,
                           doc_mask=dm, axis_name=axis)
        upd = out[tree.node_of_doc].reshape(B, D)
        new_scores = scores + learning_rate * jnp.where(mask, upd, 0.0)
        return new_scores, tree, out

    sharded = P(axis)
    repl = P()
    tree_specs = TreeArrays(
        feature=repl, bin=repl, left=repl, right=repl, is_leaf=repl,
        n_nodes=repl, node_of_doc=sharded, impacts=repl)
    mapped = jax.shard_map(
        step, mesh=mesh,
        in_specs=(sharded, sharded, sharded, sharded),
        out_specs=(sharded, tree_specs, repl),
        check_vma=False,
    )
    return jax.jit(mapped)


def shard_batch(mesh: Mesh, *arrays, axis: str = AXIS):
    """Host arrays → leading-axis-sharded device arrays over the mesh.

    Multi-process aware (review finding, round 5: the module docstring
    promises the multi-host path, but a bare device_put cannot address
    remote devices under a mesh spanning processes — the smoke test had
    to hand-roll make_array_from_process_local_data): routes through the
    same placement helper the product distributed path uses."""
    from ranklib_tpu.gbdt.boost_dist import _place

    return tuple(_place(np.asarray(a), mesh, sharded=True, axis=axis)
                 for a in arrays)
