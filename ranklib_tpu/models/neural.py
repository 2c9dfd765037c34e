"""Neural rankers: RankNet (`-ranker 1`), LambdaRank (`-ranker 5`),
ListNet (`-ranker 7`).

The reference implements these as an object graph of Neuron/Synapse/Layer
(ref: learning/neuralnet/{RankNet,LambdaRank,ListNet,Neuron,Synapse,
Layer}.java) — that entire subtree collapses here into an MLP forward and
three jitted per-query losses (SURVEY.md §2 'neural plumbing' row).

Reference semantics preserved:

* default net: 1 hidden layer × 10 neurons, logistic transfer on every
  layer including the output (ref: neuralnet/LogiFunction.java);
* one SGD step PER QUERY (the query is the minibatch; ref:
  RankNet.learn → batchFeedForward/batchBackPropagate per RankList);
* RankNet: pairwise cross-entropy over pairs (i, j) with label_i > label_j
  (gradient −ρ with ρ = 1/(1+e^{s_i−s_j}), lr 5e-5, 100 epochs);
* LambdaRank: pair gradient additionally scaled by |Δmetric| of swapping
  the pair in the CURRENT ranking, recomputed every step (ref:
  learning/neuralnet/LambdaRank.java:~20);
* ListNet: zero hidden layers (linear scorer) + top-one listwise
  cross-entropy with target P* = softmax(labels), lr 1e-5, 1500 epochs
  (ref: learning/neuralnet/ListNet.java:~20);
* per-epoch validation scoring with best-weight snapshot, restored at the
  end (ref: RankNet.saveBestModelOnValidation).

Device mapping: queries are padded into [B, D, F] buckets; one lax.scan
per bucket performs the sequential per-query updates on-device (no
per-query host round-trips); pair matrices are masked [D, D] elementwise
work; the epoch loop stays on host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ranklib_tpu.data.dataset import Dataset, iter_buckets
from ranklib_tpu.gbdt.boost import round_capacity
from ranklib_tpu.metrics.base import MetricScorer
from ranklib_tpu.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu.ops.sorting import rank_perm
from ranklib_tpu.utils.errors import RankLibError
from ranklib_tpu.utils.logging import event, is_silent, log


def _init_params(key, layer_sizes):
    """layer_sizes e.g. [F, 10, 1]; small random init like the reference."""
    params = []
    for fan_in, fan_out in zip(layer_sizes[:-1], layer_sizes[1:]):
        key, k1, k2 = jax.random.split(key, 3)
        params.append((
            jax.random.uniform(k1, (fan_in, fan_out), jnp.float32, -0.05, 0.05),
            jax.random.uniform(k2, (fan_out,), jnp.float32, -0.05, 0.05),
        ))
    return params


def _forward(params, x):
    """x [..., F] → scores [...]; logistic transfer on every layer."""
    h = x
    for W, b in params:
        h = jax.nn.sigmoid(h @ W + b)
    return h[..., 0]


def _forward_sparse(params, x, D):
    """Sparse-first-layer forward for ONE query: ``x`` is
    (fids [E], vals [E], docpos [E]) — the query's nonzero entries with
    their doc positions (padding entries carry docpos = D, sliced off).
    The first layer is the embedding-style gather/segment-sum of
    ops.sparse_eval (x @ W1 without a dense [D, F] block); later layers
    are dense as usual. Wide-data route for the neural rankers."""
    fids, vals, docpos = x
    W, b = params[0]
    h = jax.ops.segment_sum(W[fids] * vals[:, None], docpos,
                            num_segments=D + 1,
                            indices_are_sorted=True)[:D]
    h = jax.nn.sigmoid(h + b)
    for W, b in params[1:]:
        h = jax.nn.sigmoid(h @ W + b)
    return h[..., 0]


def _pair_mask(labels, mask):
    """[D, D] float: 1 where label_i > label_j and both docs real."""
    valid = mask.astype(jnp.float32)
    both = valid[:, None] * valid[None, :]
    return (labels[:, None] > labels[None, :]).astype(jnp.float32) * both


def _ranknet_query_loss(params, feats, labels, mask, scorer, fwd=_forward):
    s = fwd(params, feats)
    pm = _pair_mask(labels, mask)
    diff = s[:, None] - s[None, :]
    return jnp.sum(pm * jax.nn.softplus(-diff))


def _lambdarank_query_loss(params, feats, labels, mask, scorer,
                           fwd=_forward):
    s = fwd(params, feats)
    # |Δmetric| of swapping each pair in the current ranking (stop-grad)
    perm = rank_perm(s[None, :], mask[None, :])[0]
    inv = jnp.argsort(perm)
    L = jnp.take(labels, perm)[None, :]
    n = mask.sum()[None].astype(jnp.int32)
    d_ranked = scorer.swap_deltas(L, n)[0]            # positions space
    d_doc = d_ranked[inv][:, inv]                     # back to doc space
    w = jax.lax.stop_gradient(jnp.abs(d_doc))
    pm = _pair_mask(labels, mask)
    diff = s[:, None] - s[None, :]
    return jnp.sum(pm * w * jax.nn.softplus(-diff))


def _listnet_query_loss(params, feats, labels, mask, scorer, fwd=_forward):
    s = fwd(params, feats)
    neg = jnp.float32(-1e30)
    logp_model = jax.nn.log_softmax(jnp.where(mask, s, neg))
    p_target = jax.nn.softmax(jnp.where(mask, labels, neg))
    return -jnp.sum(jnp.where(mask, p_target * logp_model, 0.0))


_LOSSES = {
    "ranknet": _ranknet_query_loss,
    "lambdarank": _lambdarank_query_loss,
    "listnet": _listnet_query_loss,
}


@jax.jit
def _bucket_scores_fwd(params, feats):
    return _forward(params, feats)


def _sparse_query_buckets(ds) -> tuple:
    """Per-size-class sparse rows for the wide-data route:
    (fids [B, E], vals [B, E], docpos [B, E], labels [B, D], mask [B, D])
    with E = the class's max per-query nonzero count. Entries come from
    MATERIALIZED queries (lazy norm / clipping / duplicate-fid last-wins
    inherited exactly, like ops.sparse_eval.build_sparse_data); padding
    entries carry docpos = D (the forward's slice-off segment)."""
    from ranklib_tpu.data.dataset import padded_size

    groups = {}
    entries = {}
    for qi, q in enumerate(ds.queries):
        X = (ds.materialize_query(qi)
             if hasattr(ds, "materialize_query") else q.feats)
        r, f = np.nonzero(X)
        entries[qi] = (f.astype(np.int32), X[r, f].astype(np.float32),
                       r.astype(np.int32))
        groups.setdefault(padded_size(q.n), []).append(qi)
    out = []
    for D in sorted(groups):
        idxs = groups[D]
        E = max(1, max(len(entries[qi][0]) for qi in idxs))
        B = len(idxs)
        fids = np.zeros((B, E), np.int32)
        vals = np.zeros((B, E), np.float32)
        docpos = np.full((B, E), D, np.int32)
        labels = np.zeros((B, D), np.float32)
        mask = np.zeros((B, D), bool)
        for b, qi in enumerate(idxs):
            f, v, r = entries[qi]
            fids[b, : len(f)] = f
            vals[b, : len(f)] = v
            docpos[b, : len(f)] = r
            q = ds.queries[qi]
            labels[b, : q.n] = q.labels
            mask[b, : q.n] = True
        out.append((jnp.asarray(fids), jnp.asarray(vals),
                    jnp.asarray(docpos), jnp.asarray(labels),
                    jnp.asarray(mask)))
    return tuple(out)


class NNState(NamedTuple):
    """Donated carry of the fused epoch step."""

    params: tuple                # ((W, b), ...)
    best_params: tuple           # snapshot of the best-on-validation epoch
    best_val: jnp.ndarray        # []
    val_m: jnp.ndarray           # [CAP]
    mis: jnp.ndarray             # [CAP] mis-ordered pair counts (console)


def make_epoch_step(loss_name: str, scorer, lr: float, n_val_q: int,
                    track_mis: bool, axis_name: str | None = None,
                    raw: bool = False):
    """One jitted epoch: per-query SGD scans over every bucket, validation
    metric + best-weight snapshot on device — the host dispatches epochs
    asynchronously and reads everything back once after the last one (the
    same zero-sync architecture as gbdt.boost; a blocking round trip per
    epoch adds up at ListNet's 1500 epochs).

    ``axis_name``: set when the step runs per-device inside ``shard_map``
    (parallel/dp.py) — each device scans its LOCAL queries in lockstep
    and per-step gradients psum over the mesh, i.e. ``-dp n`` trains a
    synchronous minibatch of n queries per step. This is the documented
    departure from the reference's strictly sequential per-query SGD
    (identical at n = 1; standard synchronous DP-SGD otherwise — the
    gradient is SUMMED like the sequential updates it replaces, not
    averaged). Padded lockstep rows (size-class count not divisible by
    n) carry all-False masks; their gradients are forced to zero before
    the psum, which also guards the lambdarank swap-delta NaNs an
    all-padded query would produce. ``raw`` returns the untraced body.
    """
    loss_fn = _LOSSES[loss_name]

    def _scan_bucket(params, bucket):
        """One sequential per-query SGD pass over a bucket — dense rows
        (feats, labels, mask) or sparse-first-layer rows
        (fids, vals, docpos, labels, mask); see _forward_sparse."""
        sparse = len(bucket) == 5
        D = bucket[-2].shape[-1]

        def body(p, row):
            if sparse:
                f, v, dp, l, m = row
                g = jax.grad(loss_fn)(p, (f, v, dp), l, m, scorer,
                                      functools.partial(_forward_sparse,
                                                        D=D))
            else:
                f, l, m = row
                g = jax.grad(loss_fn)(p, f, l, m, scorer)
            valid = m.any()
            g = jax.tree.map(
                lambda a: jnp.where(valid, a, jnp.zeros_like(a)), g)
            if axis_name:
                g = jax.lax.psum(g, axis_name)
            return jax.tree.map(lambda a, b: a - lr * b, p, g), None

        params, _ = jax.lax.scan(body, params, bucket)
        return params

    def _bucket_scores(params, bucket):
        """[rows, D] scores of every query in a bucket."""
        if len(bucket) == 5:
            f, v, dp, l, _ = bucket
            D = l.shape[-1]
            return jax.vmap(
                lambda ff, vv, pp: _forward_sparse(params, (ff, vv, pp),
                                                   D))(f, v, dp)
        return _forward(params, bucket[0])

    def step(state: NNState, t, tb, vb) -> NNState:
        params = state.params
        for bucket in tb:
            params = _scan_bucket(params, bucket)

        mis = state.mis
        if track_mis:
            tot_mis = jnp.float32(0.0)
            for bucket in tb:
                l, m = bucket[-2], bucket[-1]
                s = _bucket_scores(params, bucket)
                pm = jax.vmap(_pair_mask)(l, m)
                bad = (s[:, :, None] <= s[:, None, :]).astype(jnp.float32)
                tot_mis += jnp.sum(pm * bad)
            if axis_name:
                tot_mis = jax.lax.psum(tot_mis, axis_name)
            mis = mis.at[t].set(tot_mis)

        best_params, best_val, val_m = (
            state.best_params, state.best_val, state.val_m)
        if vb:
            tot = jnp.float32(0.0)
            for bucket in vb:
                l, m = bucket[-2], bucket[-1]
                tot += scorer.score_from_scores(
                    l, _bucket_scores(params, bucket), m).sum()
            if axis_name:
                tot = jax.lax.psum(tot, axis_name)
            val = tot / n_val_q
            val_m = state.val_m.at[t].set(val)
            better = val > state.best_val
            best_params = jax.tree.map(
                lambda a, b: jnp.where(better, a, b), params,
                state.best_params)
            best_val = jnp.where(better, val, state.best_val)

        return NNState(params=params, best_params=best_params,
                       best_val=best_val, val_m=val_m, mis=mis)

    if raw:
        return step
    return jax.jit(step, donate_argnums=(0,))


@register_ranker
class RankNet(Ranker):
    NAME = "RankNet"
    LOSS = "ranknet"

    def __init__(self, **hp):
        self.n_epoch = 100
        self.n_layers = 1               # hidden layers
        self.n_hidden_per_layer = 10
        self.learning_rate = 0.00005
        self.seed = 0
        self.params = None              # list[(W, b)]
        self.n_features = None
        super().__init__(**hp)

    def _layer_sizes(self, F):
        return [F] + [self.n_hidden_per_layer] * self.n_layers + [1]

    def fit(self, train: Dataset, scorer: MetricScorer, validation=None,
            mesh=None):
        F = train.n_features
        self.n_features = F
        params = tuple(_init_params(jax.random.PRNGKey(self.seed),
                                    self._layer_sizes(F)))
        n_val_q = len(validation.queries) if validation is not None else 1
        lr = float(self.learning_rate)

        log(f"Training starts... [{self.NAME}] {self.n_epoch} epochs, "
            f"lr={lr:g}, layers={self._layer_sizes(F)}")
        log(f"{'#epoch':<8}| {'# mis-ordered pairs':<20}| {'validation':<10}")
        silent = is_silent()
        CAP = round_capacity(self.n_epoch)
        from ranklib_tpu.ops.sparse_eval import wants_sparse_eval

        sparse_mode = wants_sparse_eval(train)
        if sparse_mode and mesh is not None:
            log("(sparse first layer is single-device; -dp ignored)")
            mesh = None
        if mesh is not None:
            tb, vb, step, state = self._build_dist(
                train, validation, scorer, mesh, params, lr, n_val_q, CAP,
                silent)
        elif sparse_mode:
            # wide CSR: sparse-first-layer rows (gather/segment-sum —
            # no dense [B, D, F] blocks in HBM); later layers dense
            tb = _sparse_query_buckets(train)
            vb = ()
            if validation is not None:
                vb = _sparse_query_buckets(validation)
            step = make_epoch_step(self.LOSS, scorer, lr, n_val_q,
                                   track_mis=not silent)
            state = NNState(
                params=params,
                best_params=jax.tree.map(jnp.copy, params),
                best_val=jnp.float32(-np.inf),
                val_m=jnp.full((CAP,), jnp.nan, jnp.float32),
                mis=jnp.full((CAP,), jnp.nan, jnp.float32),
            )
        else:
            tb = tuple(
                (jnp.asarray(b.feats), jnp.asarray(b.labels),
                 jnp.asarray(b.mask))
                for b in iter_buckets(train)
            )
            vb = ()
            if validation is not None:
                vb = tuple(
                    (jnp.asarray(b.feats), jnp.asarray(b.labels),
                     jnp.asarray(b.mask))
                    for b in iter_buckets(validation)
                )
            step = make_epoch_step(self.LOSS, scorer, lr, n_val_q,
                                   track_mis=not silent)
            state = NNState(
                params=params,
                # distinct buffers: params and best_params live in one
                # donated pytree and may not alias
                best_params=jax.tree.map(jnp.copy, params),
                best_val=jnp.float32(-np.inf),
                val_m=jnp.full((CAP,), jnp.nan, jnp.float32),
                mis=jnp.full((CAP,), jnp.nan, jnp.float32),
            )
        for epoch in range(1, self.n_epoch + 1):
            state = step(state, epoch - 1, tb, vb)
            if not silent and (epoch % max(1, self.n_epoch // 10) == 0
                               or epoch == 1):
                mis = float(state.mis[epoch - 1])
                # the EPOCH's validation value, as the reference's table
                # prints (ref: learning/neuralnet/RankNet.java:~150) — not
                # the running best (which is only used for the snapshot)
                vm = (float(state.val_m[epoch - 1])
                      if validation is not None else None)
                vtxt = f"{vm:.4f}" if vm is not None else "-"
                log(f"{epoch:<8}| {mis:<20.0f}| {vtxt:<10}")
                event("epoch", ranker=self.NAME, epoch=epoch,
                      misordered_pairs=mis, best_val=vm)
        final = state.best_params if validation is not None else state.params
        self.params = [(np.asarray(W), np.asarray(b)) for W, b in final]

    def _build_dist(self, train, validation, scorer, mesh, params, lr,
                    n_val_q, CAP, silent):
        """Data-parallel (tb, vb, step, state): queries shard round-robin
        per size class; each device steps its local query in lockstep and
        gradients psum — a synchronous minibatch of n_dev queries per
        step (see make_epoch_step's axis_name note; identical to the
        sequential reference semantics at n_dev = 1)."""
        from jax.sharding import PartitionSpec as P_

        from ranklib_tpu.gbdt.boost_dist import AXIS
        from ranklib_tpu.parallel.dp import (
            make_dist_stepper, place_replicated, shard_feat_buckets,
        )

        n_dev = mesh.devices.size
        tb, _, _ = shard_feat_buckets(train, n_dev, mesh)
        vb = ()
        if validation is not None:
            vb, _, _ = shard_feat_buckets(validation, n_dev, mesh)
        rep = lambda a: place_replicated(np.asarray(a), mesh)
        state = NNState(
            params=jax.tree.map(rep, params),
            best_params=jax.tree.map(rep, params),
            best_val=rep(np.float32(-np.inf)),
            val_m=rep(np.full((CAP,), np.nan, np.float32)),
            mis=rep(np.full((CAP,), np.nan, np.float32)),
        )
        impl = make_epoch_step(self.LOSS, scorer, lr, n_val_q,
                               track_mis=not silent, axis_name=AXIS,
                               raw=True)
        sh, rp = P_(AXIS), P_()
        state_specs = jax.tree.map(lambda _: rp, state)
        data_specs = (jax.tree.map(lambda _: sh, tb),
                      jax.tree.map(lambda _: sh, vb))
        step = make_dist_stepper(impl, mesh, state_specs, data_specs)
        return tb, vb, step, state

    # ---- scoring -----------------------------------------------------------
    def eval_dataset(self, ds: Dataset):
        if self.params is None:
            raise RankLibError("Model not trained/loaded")
        F = self.params[0][0].shape[0]
        params = [(jnp.asarray(W), jnp.asarray(b)) for W, b in self.params]
        out = [None] * len(ds.queries)
        for b in iter_buckets(ds):
            feats = b.feats
            if ds.n_features != F:  # width mismatch between model and data
                feats = np.zeros((b.B, b.D, F), np.float32)
                w = min(F, ds.n_features)
                feats[:, :, :w] = b.feats[:, :, :w]
            s = np.asarray(_bucket_scores_fwd(params, jnp.asarray(feats)))
            for row, qi in enumerate(b.qidx):
                out[qi] = s[row, : int(b.n_docs[row])].astype(np.float64)
        return out

    # ---- serialization -----------------------------------------------------
    def model_str(self) -> str:
        sizes = [self.params[0][0].shape[0]] + [W.shape[1] for W, _ in self.params]
        hdr = model_header(self.NAME, {
            "Epochs": self.n_epoch,
            "No. of features": sizes[0],
            "No. of hidden layers": len(sizes) - 2,
            "No. of hidden nodes per layer": self.n_hidden_per_layer,
            "Learning rate": self.learning_rate,
            "Layer sizes": " ".join(map(str, sizes)),
        })
        chunks = []
        for W, b in self.params:
            chunks.append(" ".join(repr(float(x)) for x in W.flatten()))
            chunks.append(" ".join(repr(float(x)) for x in b.flatten()))
        return hdr + "\n".join(chunks) + "\n"

    def load_str(self, text: str) -> None:
        params, body = parse_model_params(text)
        try:
            sizes = [int(s) for s in params["Layer sizes"].split()]
        except KeyError:
            raise RankLibError(f"{self.NAME} model missing 'Layer sizes'") from None
        if "Epochs" in params:
            self.n_epoch = int(params["Epochs"])
        if "Learning rate" in params:
            self.learning_rate = float(params["Learning rate"])
        self.n_layers = len(sizes) - 2
        if self.n_layers > 0:
            self.n_hidden_per_layer = sizes[1]
        vals = iter(body)
        out = []
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            W = np.array(next(vals).split(), np.float64).reshape(fan_in, fan_out)
            b = np.array(next(vals).split(), np.float64)
            out.append((W.astype(np.float32), b.astype(np.float32)))
        self.params = out
        self.n_features = sizes[0]


@register_ranker
class LambdaRank(RankNet):
    NAME = "LambdaRank"
    LOSS = "lambdarank"


@register_ranker
class ListNet(RankNet):
    NAME = "ListNet"
    LOSS = "listnet"

    def __init__(self, **hp):
        super().__init__()
        self.n_epoch = 1500
        self.learning_rate = 0.00001
        self.n_layers = 0               # linear scorer (ref: ListNet)
        for k, v in hp.items():
            if not hasattr(self, k):
                raise RankLibError(f"{self.NAME}: unknown hyperparameter '{k}'")
            setattr(self, k, v)
