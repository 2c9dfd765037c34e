"""MART (`-ranker 0`) and LambdaMART (`-ranker 6`).

Reference behavior (learning/tree/LambdaMART.java:~40 init, :~200 learn;
learning/tree/MART.java:~15):

* init: flatten all docs, compute ≤ nThreshold candidate split values per
  feature, pre-bin;
* per tree: pseudo-responses (lambda gradients for LambdaMART, plain
  residuals label − score for MART) → fit a leaf-wise regression tree on
  them → re-estimate leaf outputs (Newton Σλ/Σw for LambdaMART, mean
  residual for MART) → modelScores += learningRate · tree(x);
* validation scored every round; after the loop the ensemble is truncated
  to the best validation round; training stops early after ``-estop``
  rounds without validation improvement.

Array-first: every boosting round is ONE fused jitted step with donated
buffers and no host sync (gbdt.boost) — pair gradients as batched
[B, D, D] programs, tree growth as a jitted fori_loop over the
segment-sum histogram (gbdt.grow, ops.histogram), metrics and the packed tree
ensemble accumulating on device. Hyperparameter flags/defaults:
``-tree`` 1000, ``-leaf`` 10, ``-shrinkage`` 0.1, ``-tc`` 256, ``-mls`` 1,
``-estop`` 100.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ranklib_tpu.data.dataset import Dataset, flatten, flatten_meta
from ranklib_tpu.gbdt.binning import bin_features, compute_thresholds
from ranklib_tpu.gbdt.boost import init_state, make_boost_data, make_round_step
from ranklib_tpu.gbdt.ensemble import Tree, TreeEnsemble
from ranklib_tpu.metrics.base import MetricScorer
from ranklib_tpu.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu.utils.errors import RankLibError
from ranklib_tpu.utils.logging import event, is_silent, log


@register_ranker
class LambdaMART(Ranker):
    NAME = "LambdaMART"
    _NEWTON = True          # leaf output Σλ/Σw (MART: mean residual)
    _POINTWISE = False      # lambda gradients (MART: plain residuals)

    def __init__(self, **hp):
        self.n_trees = 1000
        self.n_leaves = 10
        self.learning_rate = 0.1
        self.n_threshold = 256
        self.min_leaf_support = 1
        self.early_stop = 100
        self.ckpt_every = 0          # save a checkpoint every N rounds
        self.ckpt_path = "model.ckpt"
        self.ensemble = TreeEnsemble()
        self.feature_impacts = None  # [F] deviance reduction, set by fit()
        super().__init__(**hp)
        if self.n_leaves < 2:
            # a 1-leaf tree is a constant; the static growth arrays assume
            # at least one split (fail here, not deep in tree export)
            raise RankLibError(
                f"-leaf must be >= 2 (got {self.n_leaves})")

    def fit(self, train: Dataset, scorer: MetricScorer,
            validation: Dataset | None = None, mesh=None,
            feature_mask: np.ndarray | None = None,
            prebinned=None) -> None:
        """``mesh``: optional ``jax.sharding.Mesh`` — queries shard
        data-parallel over its first axis with psum'd histogram/metric
        statistics (gbdt.boost_dist).

        ``feature_mask``: optional [F] bool — features outside the mask are
        never split on (RF feature bagging). ``prebinned``: optional
        (thresholds [F, B], binned [N, F]) computed by the caller for this
        dataset's docs in flatten order — RF bags share one global binning
        so 300 bags skip 300 host re-binnings and one compiled step serves
        them all.
        """
        if mesh is not None and mesh.size > 1:
            return self._fit_distributed(train, scorer, validation, mesh,
                                         feature_mask, prebinned)
        # streaming -sparse datasets carry their bin matrix and grid and
        # no raw feature values at all (data.binned); everything below is
        # bit-identical to binning the dense matrix with the same grid.
        # A caller-prebinned FEATS-FREE dataset (RF bagging over a
        # streamed file: sampled query subsets + rows of the shared bin
        # matrix) takes the same labels-only path.
        stream = getattr(train, "binned", None) is not None
        featless = (prebinned is not None and len(train.queries) > 0
                    and train.queries[0].feats is None)
        feats = None
        if stream or featless:
            labels, _ = flatten_meta(train)
            thresholds, binned_real = ((train.thresholds, train.binned)
                                       if stream else prebinned)
            N, F = binned_real.shape
        else:
            feats, labels, _ = flatten(train)
            N, F = feats.shape
            # thresholds from REAL docs only, then pad the doc axis to a
            # coarse grid so RF bags / CV folds of varying size reuse one
            # compilation
            if prebinned is not None:
                thresholds, binned_real = prebinned
            else:
                thresholds, _ = compute_thresholds(feats, self.n_threshold)
                binned_real = None
        B = thresholds.shape[1]
        Npad = _pad_doc_count(N)
        if binned_real is None:
            binned = bin_features(
                np.pad(feats, ((0, Npad - N), (0, 0))), thresholds)
        else:
            binned = np.pad(binned_real, ((0, Npad - N), (0, 0)))
        labels_pad = np.pad(labels, (0, Npad - N)).astype(np.float32)

        vbinned = None
        vfeats = None
        if validation is not None:
            if getattr(validation, "binned", None) is not None:
                vbinned = validation.binned
            else:
                vfeats, _, _ = flatten(validation)
                vbinned = bin_features(vfeats, thresholds)

        data, Npad, Nvpad = make_boost_data(
            train, binned, labels_pad, N, validation, vbinned, feature_mask,
            scorer=None if self._POINTWISE else scorer)

        # warm start: a loaded/partial ensemble seeds the model scores and
        # training continues toward n_trees total (resume-after-crash /
        # incremental training; the reference's only resume semantics is
        # its validation-best rollback, SURVEY.md §5 checkpoint row)
        prior = TreeEnsemble()
        rounds = self.n_trees
        init_scores = init_vscores = None
        if len(self.ensemble):
            prior = self.ensemble
            rounds = max(0, self.n_trees - len(prior))
            if feats is None:          # stream / featless-prebinned
                # no raw values to evaluate on: score the prior ensemble in
                # bin space (exact when its grid is this grid)
                ens_bin = prior.to_bin_space(thresholds)
                init_scores = _eval_binned(ens_bin, binned_real)
                if validation is not None:
                    init_vscores = _eval_binned(ens_bin, vbinned)
            else:
                init_scores = prior.eval_matrix(feats[:N])
                if validation is not None:
                    # a PRE-BINNED validation set next to a dense train
                    # set has no raw values (review finding: NameError);
                    # its bins carry this grid, so bin-space is exact
                    init_vscores = (
                        prior.eval_matrix(vfeats) if vfeats is not None
                        else _eval_binned(prior.to_bin_space(thresholds),
                                          vbinned))
            log(f"Warm start from {len(prior)} trees "
                f"({rounds} rounds to go)")

        silent = is_silent()
        step = make_round_step(
            scorer, n_bins=B, n_leaves=self.n_leaves,
            min_leaf_support=self.min_leaf_support,
            learning_rate=self.learning_rate,
            pointwise=self._POINTWISE, newton=self._NEWTON,
            n_queries=len(train.queries),
            n_vqueries=len(validation.queries) if validation is not None else 1,
            # the per-round train metric only feeds the console table
            train_metric=not silent)
        state = init_state(rounds, self.n_leaves, Npad, Nvpad, F)
        if init_scores is not None:
            state = state._replace(
                scores=state.scores.at[:N].set(jnp.asarray(init_scores)))
        if init_vscores is not None:
            state = state._replace(
                vscores=state.vscores.at[:len(init_vscores)].set(
                    jnp.asarray(init_vscores)))

        log("Training starts...")
        self._boost_loop(step, state, data, scorer, validation is not None,
                         rounds, thresholds, prior)

    def _boost_loop(self, step, state, data, scorer, has_val: bool,
                    rounds: int, thresholds, prior: TreeEnsemble) -> None:
        """Shared round loop (single-device and mesh paths): console table,
        JSONL events, periodic checkpoints, early stop, best-round
        rollback, ensemble export."""
        head = f"{'#iter':<8}| {scorer.name + '-T':<11}"
        if has_val:
            head += f"| {scorer.name + '-V':<11}"
        log(head)

        def export(state, upto, keep):
            arrs = jax.device_get((state.tfeat, state.tbin, state.tleft,
                                   state.tright, state.tleaf, state.tout,
                                   state.tnodes))
            ens = TreeEnsemble()
            for tree, w in zip(prior.trees, prior.weights):
                ens.add(tree, w)
            for i in range(min(keep, upto)):
                ens.add(_export_tree(arrs[0][i], arrs[1][i], arrs[2][i],
                                     arrs[3][i], arrs[4][i], arrs[5][i],
                                     int(arrs[6][i]), thresholds),
                        self.learning_rate)
            return ens

        silent = is_silent()
        # silent (bench/production) mode: only sync at early-stop checkpoints
        check = 1 if not silent else max(1, min(self.early_stop or 50, 50))
        multi = getattr(step, "multi", None)
        built = 0
        t = 0
        stopped = False
        while t < rounds:
            # chain every round up to the next host event (per-round table
            # line when not silent, else checkpoint write or early-stop
            # check) in ONE dispatch — per-round dispatch costs host
            # latency every round. All modes run the SAME chained
            # executable (chunk length 1 when live-printing), so models
            # are bit-identical at any sync cadence.
            if silent:
                # cap a single dispatch at 128 rounds, which bounds the
                # length of one device call; the extra syncs are noise
                # against multi-second chunks. Whether the cap costs
                # anything on the card is not measured yet.
                nxt = min(rounds, t + 128)
                if self.ckpt_every:
                    nxt = min(nxt,
                              (t // self.ckpt_every + 1) * self.ckpt_every)
                if has_val and self.early_stop > 0:
                    nxt = min(nxt, (t // check + 1) * check)
            else:
                nxt = t + 1
            if multi is not None:
                state = multi(state, t, nxt, data)
            else:
                for k in range(t, nxt):
                    state = step(state, k, data)
            built = nxt
            t = nxt
            if not silent:
                tm = float(state.train_m[t - 1])
                line = f"{t:<8}| {tm:<11.4f}"
                vm = None
                if has_val:
                    vm = float(state.val_m[t - 1])
                    line += f"| {vm:<11.4f}"
                log(line)
                event("round", ranker=self.NAME, round=t,
                      train_metric=tm, val_metric=vm)
            if self.ckpt_every and built % self.ckpt_every == 0:
                self.ensemble = export(state, built, built)
                self.save(self.ckpt_path)
            if has_val and self.early_stop > 0 and built % check == 0:
                # replay the reference's per-round rule over the history so
                # the stop ROUND is identical no matter how rarely the host
                # syncs (silent mode checks in batches; a late new best must
                # not resurrect a run that had already stopped semantically)
                hist = np.asarray(state.val_m[:built])
                sr = _stop_round(hist, self.early_stop)
                if sr is not None:
                    built = sr
                    stopped = True
                    log(f"Early stop at round {built} "
                        f"(no validation gain in {self.early_stop} rounds)")
                    break

        if has_val and self.early_stop > 0 and built and not stopped:
            # the final chunk may not land on the modulo gate (warm
            # starts / -tree not a multiple of the check stride): replay
            # the stop rule over the FULL history so a semantic stop in
            # the last chunk still clamps `built` before rollback
            # (review finding)
            sr = _stop_round(np.asarray(state.val_m[:built]),
                             self.early_stop)
            if sr is not None:
                built = sr
                log(f"Early stop at round {built} "
                    f"(no validation gain in {self.early_stop} rounds)")

        keep = built
        if has_val and built:
            # rollback to the best validation round (ref: LambdaMART learn()
            # post-loop ensemble truncation)
            val_m = jax.device_get(state.val_m)
            keep = int(np.nanargmax(val_m[:built])) + 1
        self.ensemble = export(state, built, keep)
        # per-feature deviance reduction over all splits (ref: LambdaMART
        # impacts[] — printed after training, SURVEY.md §2 row 6)
        self.feature_impacts = np.asarray(jax.device_get(state.impacts),
                                          np.float64)
        if not silent and self.feature_impacts.any():
            top = np.argsort(-self.feature_impacts)[:10]
            log("-- Feature impacts (top 10, deviance reduced)")
            for f in top:
                if self.feature_impacts[f] <= 0:
                    break
                log(f"  Feature {f + 1} : {self.feature_impacts[f]:.6g}")

    def _fit_distributed(self, train: Dataset, scorer: MetricScorer,
                         validation, mesh, feature_mask=None,
                         prebinned=None) -> None:
        from ranklib_tpu.gbdt.boost_dist import (
            build_sharded_data, init_dist_state, make_dist_round_step,
        )

        n_dev = mesh.size
        stream = getattr(train, "binned", None) is not None
        feats = None
        if stream:
            thresholds, binned = train.thresholds, train.binned
        elif prebinned is not None:
            # prebinned datasets may be feats-free (RF bags over a
            # streamed file) — never flatten raw values here
            thresholds, binned = prebinned
        else:
            feats, _, _ = flatten(train)
            thresholds, _ = compute_thresholds(feats, self.n_threshold)
            binned = bin_features(feats, thresholds)
        B = thresholds.shape[1]
        vbinned = None
        vfeats = None
        if validation is not None:
            if getattr(validation, "binned", None) is not None:
                vbinned = validation.binned
            else:
                vfeats, _, _ = flatten(validation)
                vbinned = bin_features(vfeats, thresholds)
        data, Npad, Nvpad = build_sharded_data(
            train, binned, n_dev, validation, vbinned, feature_mask,
            mesh=mesh, scorer=None if self._POINTWISE else scorer)
        silent = is_silent()
        step = make_dist_round_step(
            scorer, mesh, data, n_bins=B, n_leaves=self.n_leaves,
            min_leaf_support=self.min_leaf_support,
            learning_rate=self.learning_rate, pointwise=self._POINTWISE,
            newton=self._NEWTON, n_queries=len(train.queries),
            n_vqueries=(len(validation.queries) if validation is not None
                        else 1),
            train_metric=not silent)
        state = init_dist_state(self.n_trees, self.n_leaves, n_dev, Npad,
                                mesh, Nvpad, n_features=binned.shape[1])

        # warm start (same semantics as the single-device path): seed the
        # sharded model scores from the loaded/partial ensemble and train
        # the remaining rounds on top of it
        prior = TreeEnsemble()
        rounds = self.n_trees
        if len(self.ensemble):
            from ranklib_tpu.gbdt.boost_dist import _place, scatter_doc_values
            prior = self.ensemble
            rounds = max(0, self.n_trees - len(prior))
            if feats is None:          # stream / prebinned warm start
                ens_bin = prior.to_bin_space(thresholds)
                sc = _eval_binned(ens_bin, binned)
                vsc = (_eval_binned(ens_bin, vbinned)
                       if validation is not None else None)
            else:
                sc = prior.eval_matrix(feats)
                # pre-binned validation next to dense train: bin-space
                # (exact on this grid; vfeats is unbound there)
                vsc = (None if validation is None
                       else prior.eval_matrix(vfeats)
                       if vfeats is not None
                       else _eval_binned(prior.to_bin_space(thresholds),
                                         vbinned))
            init = scatter_doc_values(train, sc, n_dev, Npad)
            state = state._replace(scores=_place(init, mesh, sharded=True))
            if validation is not None:
                vinit = scatter_doc_values(validation, vsc, n_dev, Nvpad)
                state = state._replace(
                    vscores=_place(vinit, mesh, sharded=True))
            log(f"Warm start from {len(prior)} trees "
                f"({rounds} rounds to go)")

        log(f"Training starts... [data-parallel over {n_dev} devices]")
        self._boost_loop(step, state, data, scorer, validation is not None,
                         rounds, thresholds, prior)

    # ---- scoring ---------------------------------------------------------
    def eval_dataset(self, ds: Dataset):
        if not len(self.ensemble):
            raise RankLibError("Model not trained/loaded")
        if getattr(ds, "binned", None) is not None:
            # streaming -sparse dataset: evaluate in bin space (exact —
            # this model was trained on this grid)
            flat = _eval_binned(self.ensemble.to_bin_space(ds.thresholds),
                                ds.binned)
            _, qptr = flatten_meta(ds)
            return [flat[qptr[i]: qptr[i + 1]]
                    for i in range(len(ds.queries))]
        return eval_ensemble_dataset(self.ensemble, ds)

    # ---- serialization -----------------------------------------------------
    def model_str(self) -> str:
        return model_header(self.NAME, {
            "No. of trees": len(self.ensemble),
            "No. of leaves": self.n_leaves,
            "No. of threshold candidates": self.n_threshold,
            "Learning rate": self.learning_rate,
            "Stop early": self.early_stop,
        }) + "\n" + self.ensemble.to_text()

    def load_str(self, text: str) -> None:
        params, _ = parse_model_params(text)
        if "No. of leaves" in params:
            self.n_leaves = int(params["No. of leaves"])
        if "Learning rate" in params:
            self.learning_rate = float(params["Learning rate"])
        self.ensemble = TreeEnsemble.from_text(text)
        if "No. of trees" in params:
            self.n_trees = int(params["No. of trees"])


@register_ranker
class MART(LambdaMART):
    """Pointwise GBRT: pseudo-responses are plain residuals and leaf
    outputs are mean residuals (ref: learning/tree/MART.java:~15 —
    overrides computePseudoResponses and updateTreeOutput, inherits all
    tree machinery)."""

    NAME = "MART"
    _NEWTON = False
    _POINTWISE = True


def eval_ensemble_dataset(ensemble, ds):
    """Per-query scores of a TreeEnsemble over a dense OR CSR dataset
    (CSR: bounded dense chunks through eval_matrix). Shared by the GBDT
    family and RFRanker."""
    max_fid = 1 + max(int(t.feature.max()) for t in ensemble.trees)
    if (ds.queries and ds.queries[0].feats is None
            and hasattr(ds, "materialize_rows")):
        from ranklib_tpu.data.sparse import _chunk_bytes

        F = max(ds.n_features, max_fid)
        rows = max(1, _chunk_bytes() // (F * 4))
        N = ds.n_docs
        flat = np.concatenate([
            ensemble.eval_matrix(
                ds.materialize_rows(lo, min(lo + rows, N), width=F))
            for lo in range(0, N, rows)])
        _, qptr = flatten_meta(ds)
        return [flat[qptr[i]: qptr[i + 1]] for i in range(len(ds.queries))]
    feats, _, qptr = flatten(ds)
    if feats.shape[1] < max_fid:
        feats = np.pad(feats, ((0, 0), (0, max_fid - feats.shape[1])))
    flat = ensemble.eval_matrix(feats)
    return [flat[qptr[i]: qptr[i + 1]] for i in range(len(ds.queries))]


def _eval_binned(ens_bin: TreeEnsemble, bins: np.ndarray,
                 chunk: int = 1 << 18) -> np.ndarray:
    """Score a bin-space ensemble (TreeEnsemble.to_bin_space) over an
    int16 bin matrix, casting to f32 in doc chunks so the cast never
    materializes a second full-size matrix."""
    out = np.empty(bins.shape[0], np.float64)
    for lo in range(0, bins.shape[0], chunk):
        hi = min(lo + chunk, bins.shape[0])
        out[lo:hi] = ens_bin.eval_matrix(bins[lo:hi].astype(np.float32))
    return out


def _stop_round(hist: np.ndarray, estop: int):
    """Replay the reference's per-round early-stop rule over a validation
    history: stop after the FIRST round t (1-based return) with
    t - best_so_far >= estop, where ties keep the earliest best (the
    reference's strict `>` improvement test — ref: LambdaMART learn()).
    Returns the 1-based round count to truncate training to, or None."""
    best = 0
    for t in range(len(hist)):
        if not np.isnan(hist[t]) and (np.isnan(hist[best])
                                      or hist[t] > hist[best]):
            best = t
        if t - best >= estop:
            return t + 1
    return None


def flatten_binned(train, n_threshold: int):
    """Shared fit preamble (review finding, round 5: four drifting
    copies across gbdt/rf): (feats|None, labels, qptr, thresholds,
    binned_real|None, N, F). Streamed -sparse datasets carry their own
    bin matrix + grid and no raw values; dense data computes the grid
    from real docs only."""
    from ranklib_tpu.data.dataset import flatten, flatten_meta
    from ranklib_tpu.gbdt.binning import compute_thresholds

    if getattr(train, "binned", None) is not None:
        labels, qptr = flatten_meta(train)
        N, F = train.binned.shape
        return None, labels, qptr, train.thresholds, train.binned, N, F
    feats, labels, qptr = flatten(train)
    N, F = feats.shape
    thresholds, _ = compute_thresholds(feats, n_threshold)
    return feats, labels, qptr, thresholds, None, N, F


def pad_binned(feats, binned_real, thresholds, labels, N: int):
    """Pad the doc axis to the compile-grid count and produce the padded
    bin matrix (+ labels): dense data bins AFTER padding (pad rows bin
    wherever 0.0 lands — inert, zero doc weight), pre-binned data pads
    with bin 0 (same inertness)."""
    from ranklib_tpu.gbdt.binning import bin_features

    Npad = _pad_doc_count(N)
    if binned_real is None:
        binned = bin_features(np.pad(feats, ((0, Npad - N), (0, 0))),
                              thresholds)
    else:
        binned = np.pad(binned_real, ((0, Npad - N), (0, 0)))
    labels_pad = np.pad(labels, (0, Npad - N)).astype(np.float32)
    return binned, labels_pad, Npad


def _pad_doc_count(n: int) -> int:
    """Quantize the flattened doc count so differently-sized inputs (RF
    bags, CV folds) hit the same compiled tree-grower."""
    if n <= 256:
        return 256
    if n < 4096:
        p = 256
        while p < n:
            p *= 2
        return p
    return ((n + 4095) // 4096) * 4096


def _export_tree(feature, sbin, left, right, is_leaf, out, n_nodes,
                 thresholds) -> Tree:
    """Device tree slots → host Tree with real threshold floats."""
    n = max(n_nodes, 1)
    feature = feature[:n]
    sbin = sbin[:n]
    is_leaf = is_leaf[:n]
    internal = (~is_leaf) & (feature >= 0)
    thr = np.zeros(n, np.float32)
    thr[internal] = thresholds[feature[internal], sbin[internal]]
    return Tree(feature=np.maximum(feature, 0), threshold=thr,
                left=left[:n], right=right[:n], is_leaf=is_leaf,
                output=out[:n])
