"""Random Forests ranker (`-ranker 8`).

Reference behavior (learning/tree/RFRanker.java:~25): ``nBag`` (300)
bagged MART (or LambdaMART, ``-rtype`` 0/6 only) ensembles. Per bag:
queries subsampled with replacement at ``subSamplingRate`` (1.0), features
subsampled at ``featureSamplingRate`` (0.3); the bag ranker trains with
bag-local hyperparams (``-tree`` 1, ``-leaf`` 100, shrinkage 0.1). Final
score = MEAN of the per-bag ensemble scores; the model file concatenates
the per-bag ``<ensemble>`` blocks under one ``## Random Forests`` header.

Offline bag merging (the reference's Combiner, learning/Combiner.java:~20)
reappears as :func:`ranklib_tpu.combiner.combine`.
"""

from __future__ import annotations

import functools

import jax
import numpy as np

from ranklib_tpu.data.dataset import Dataset, flatten, flatten_meta
from ranklib_tpu.data.sampling import sample_features, sample_queries
from ranklib_tpu.gbdt.ensemble import TreeEnsemble
from ranklib_tpu.metrics.base import MetricScorer
from ranklib_tpu.models.base import (
    Ranker, model_header, parse_model_params, register_ranker,
)
from ranklib_tpu.models.gbdt import MART, LambdaMART
from ranklib_tpu.utils.errors import RankLibError
from ranklib_tpu.utils.logging import log, set_silent, is_silent


def _bag_train_metric(ens: TreeEnsemble, sampled: Dataset, idx, qptr,
                      binned, thresholds, stream: bool, scorer) -> float:
    """Per-bag train metric for the non-silent console table. Dense bags
    score through eval_matrix; streamed -sparse bags have no raw values,
    so the bag ensemble is rebased to bin space and scored on the
    sampled rows of the shared bin matrix (exact — its thresholds ARE
    grid points)."""
    from ranklib_tpu.metrics.base import score_dataset

    if stream:
        from ranklib_tpu.models.gbdt import _eval_binned

        rows = (np.concatenate([np.arange(qptr[i], qptr[i + 1])
                                for i in idx])
                if len(idx) else np.zeros(0, np.int64))
        flat = _eval_binned(ens.to_bin_space(thresholds), binned[rows])
    else:
        sfeats, _, _ = flatten(sampled)
        flat = ens.eval_matrix(sfeats)
    sqptr = np.zeros(len(sampled.queries) + 1, np.int64)
    np.cumsum([q.n for q in sampled.queries], out=sqptr[1:])
    scores = [flat[sqptr[i]: sqptr[i + 1]]
              for i in range(len(sampled.queries))]
    return score_dataset(scorer, sampled, scores)[0]


@functools.partial(
    jax.jit, static_argnames=("n_bins", "n_leaves", "lr"),
    donate_argnums=(0,))
def _rf_group_step(scores, mult, fmask, query_of_doc, binned_T, labels,
                   n_bins: int, n_leaves: int, lr: float):
    """One lockstep MART round for a group of bags: residuals → forest →
    mean-residual leaf outputs → score update. Module-level so repeated
    fits in one process hit the in-process jit cache (a per-fit closure
    would re-enter the compilation cache each time). Transfer discipline:
    bags arrive as per-QUERY multiplicities ``mult`` [Cb, Q+1]
    (~100× smaller than per-doc weights) and are expanded on device via
    ``query_of_doc`` (pad docs point at the zero sentinel column Q);
    returns only the host-exported tree arrays — node_of_doc ([Cb, N])
    stays on device (dead weight for model export)."""
    import jax.numpy as jnp

    from ranklib_tpu.gbdt.grow import grow_forest, leaf_outputs_forest

    M = 2 * n_leaves - 1
    doc_w = mult[:, query_of_doc]               # [Cb, Npad] on device
    lam = labels[None, :] - scores              # MART residuals
    arr = grow_forest(binned_T, lam, n_bins=n_bins, n_leaves=n_leaves,
                      min_leaf_support=1, doc_weights=doc_w,
                      feature_masks=fmask)
    out = leaf_outputs_forest(arr.node_of_doc, lam, jnp.ones_like(lam), M,
                              False, doc_w)
    scores = scores + lr * jnp.take_along_axis(out, arr.node_of_doc, axis=1)
    tree = (arr.feature, arr.bin, arr.left, arr.right, arr.is_leaf,
            arr.n_nodes, out)
    return scores, tree


def _bag_group_size(M: int, F: int, B: int, n_bags: int) -> int:
    """Bags grown in lockstep per group. Bounded by (a) the [Cb, M, F, B, 2]
    histogram slot buffer (~6 GB budget with 2× loop-carry headroom) and
    (b) 64 bags per group. Kept a multiple of 4 so group shapes stay
    few; a single
    undersized final group is padded with zero-weight bags instead of
    recompiling at a second group size."""
    slot = M * F * B * 8
    cap = min(64, max(1, int(6e9 // (2 * slot))))
    if cap < 4:
        return cap
    if n_bags <= cap:
        return min(cap, -(-n_bags // 4) * 4)
    return (cap // 4) * 4


@register_ranker
class RFRanker(Ranker):
    NAME = "Random Forests"

    def __init__(self, **hp):
        self.n_bags = 300
        self.sub_sampling_rate = 1.0
        self.feature_sampling_rate = 0.3
        self.ranker_type = 0            # 0 = MART, 6 = LambdaMART
        self.n_trees = 1
        self.n_leaves = 100
        self.learning_rate = 0.1
        self.n_threshold = 256
        self.seed = 0
        self.ensembles: list[TreeEnsemble] = []
        self._merged = None
        super().__init__(**hp)
        if self.ranker_type not in (0, 6):
            raise RankLibError(
                "Random Forests supports -rtype 0 (MART) or 6 (LambdaMART)")

    def fit(self, train: Dataset, scorer: MetricScorer,
            validation: Dataset | None = None, mesh=None,
            feature_mask: np.ndarray | None = None) -> None:
        """``feature_mask``: optional [F] bool (-feature on the streamed
        -sparse path) — intersected with every bag's sampled feature set,
        exactly equivalent to the dense pipeline's column zeroing (a
        zeroed column can never win a split)."""
        if mesh is not None and mesh.size > 1:
            return self._fit_bags_rebuild(train, scorer, mesh,
                                          feature_mask)
        if self.ranker_type == 0:
            return self._fit_bags_batched(train, scorer, feature_mask)
        import jax
        import jax.numpy as jnp

        from ranklib_tpu.gbdt.boost import (
            init_state, make_boost_data, make_round_step,
        )
        from ranklib_tpu.models.gbdt import (
            _export_tree, flatten_binned, pad_binned,
        )

        rng = np.random.default_rng(self.seed)
        log("Training starts...")
        # Weighted bags over ONE device-resident dataset: with-replacement
        # query sampling becomes an [N] f32 multiplicity vector (weight k ≡
        # the doc duplicated k times in every histogram/count/leaf sum) and
        # feature subsampling an [F] mask — per bag the host ships a few
        # hundred KB and re-dispatches the SAME compiled fused round, no
        # re-binning, no re-bucketing (the reference trains each bag as a
        # separate MART run, RFRanker.java:~25).
        stream = getattr(train, "binned", None) is not None
        feats, labels, qptr, thresholds, binned_real, N, F = (
            flatten_binned(train, self.n_threshold))
        Q = len(train.queries)
        doc_counts = np.diff(qptr)
        B = thresholds.shape[1]
        binned, labels_pad, Npad = pad_binned(feats, binned_real,
                                              thresholds, labels, N)
        pointwise = self.ranker_type == 0
        data, Npad, _ = make_boost_data(train, binned, labels_pad, N,
                                        None, None,
                                        scorer=None if pointwise else scorer)
        step = make_round_step(
            scorer, n_bins=B, n_leaves=self.n_leaves, min_leaf_support=1,
            learning_rate=self.learning_rate, pointwise=pointwise,
            newton=not pointwise, n_queries=Q, n_vqueries=1,
            train_metric=False)

        self.ensembles = []
        silent = is_silent()
        for bag in range(self.n_bags):
            sampled, _, qidx = sample_queries(train, self.sub_sampling_rate,
                                              rng)
            fids = sample_features(F, self.feature_sampling_rate, rng)
            fmask = np.zeros(F, bool)
            fmask[[f - 1 for f in fids]] = True
            if feature_mask is not None:
                fmask &= feature_mask
            mult = np.bincount(qidx, minlength=Q).astype(np.float32)
            doc_w = np.zeros(Npad, np.float32)
            doc_w[:N] = np.repeat(mult, doc_counts)
            bag_data = data._replace(doc_mask=jnp.asarray(doc_w),
                                     feat_mask=jnp.asarray(fmask))
            state = init_state(self.n_trees, self.n_leaves, Npad, 0, F)
            # chained rounds with no host event between them — capped per
            # dispatch like gbdt._boost_loop, and SCALED by leaf count:
            # growth cost ~ n_leaves, so gbdt's 128-round cap (sized for
            # 10 leaves) is ~10x too long at the RF default -leaf 100
            cap = max(8, 1280 // max(10, self.n_leaves))
            t = 0
            while t < self.n_trees:
                nxt = min(self.n_trees, t + cap)
                state = step.multi(state, t, nxt, bag_data)
                t = nxt
            arrs = jax.device_get((state.tfeat, state.tbin, state.tleft,
                                   state.tright, state.tleaf, state.tout,
                                   state.tnodes))
            ens = TreeEnsemble()
            for i in range(self.n_trees):
                ens.add(_export_tree(arrs[0][i], arrs[1][i], arrs[2][i],
                                     arrs[3][i], arrs[4][i], arrs[5][i],
                                     int(arrs[6][i]), thresholds),
                        self.learning_rate)
            self.ensembles.append(ens)
            if not silent:
                m = _bag_train_metric(ens, sampled, qidx, qptr, binned,
                                      thresholds, stream, scorer)
                log(f"bag {bag + 1:<5}| {scorer.name}-bag: {m:.4f}")
        self._merged = None

    def _fit_bags_batched(self, train: Dataset, scorer: MetricScorer,
                          feature_mask: np.ndarray | None = None) -> None:
        """Batched-bag fit for ``-rtype 0`` (the default): groups of bags
        grow their trees in LOCKSTEP via gbdt.grow.grow_forest, so the
        growth loop, its split scans and its dispatches are paid once per
        split for the whole group instead of once per bag. Bag semantics — rng order, weighted
        with-replacement query sampling, feature masks, mean-residual leaf
        outputs — are identical to the sequential path; on CPU the grown
        trees are bit-identical (tests/test_boosting_rf.py)."""
        import jax.numpy as jnp

        from ranklib_tpu.gbdt.boost import _upload_bins
        from ranklib_tpu.models.gbdt import (
            _export_tree, flatten_binned, pad_binned,
        )

        rng = np.random.default_rng(self.seed)
        log("Training starts...")
        stream = getattr(train, "binned", None) is not None
        feats, labels, qptr, thresholds, binned_real, N, F = (
            flatten_binned(train, self.n_threshold))
        Q = len(train.queries)
        doc_counts = np.diff(qptr)
        B = thresholds.shape[1]
        binned, labels_pad_np, Npad = pad_binned(feats, binned_real,
                                                 thresholds, labels, N)
        binned_T = _upload_bins(np.ascontiguousarray(binned.T))
        labels_dev = jnp.asarray(labels_pad_np)

        # Bag sampling happens upfront IN BAG ORDER — the rng consumption
        # (and so every bag's composition) matches the sequential path.
        bag_m, bag_f, bag_samples, bag_idx = [], [], [], []
        for _ in range(self.n_bags):
            sampled, _, qidx = sample_queries(train, self.sub_sampling_rate,
                                              rng)
            fids = sample_features(F, self.feature_sampling_rate, rng)
            fmask = np.zeros(F, bool)
            fmask[[f - 1 for f in fids]] = True
            if feature_mask is not None:
                fmask &= feature_mask
            bag_m.append(np.bincount(qidx, minlength=Q).astype(np.float32))
            bag_f.append(fmask)
            bag_samples.append(sampled)
            bag_idx.append(qidx)
        # doc→query map with a zero-weight sentinel query Q for pad docs
        qod = np.full(Npad, Q, np.int32)
        qod[:N] = np.repeat(np.arange(Q, dtype=np.int32), doc_counts)
        query_of_doc = jnp.asarray(qod)

        M = 2 * self.n_leaves - 1
        Cb = _bag_group_size(M, F, B, self.n_bags)
        lr = self.learning_rate

        self.ensembles = []
        silent = is_silent()
        for lo in range(0, self.n_bags, Cb):
            n_real = min(Cb, self.n_bags - lo)
            m = np.zeros((Cb, Q + 1), np.float32)       # col Q = pad docs
            fm = np.ones((Cb, F), bool)                 # pad bags: no-ops
            m[:n_real, :Q] = bag_m[lo:lo + n_real]
            fm[:n_real] = np.stack(bag_f[lo:lo + n_real])
            mult = jnp.asarray(m)
            fmask = jnp.asarray(fm)
            scores = jnp.zeros((Cb, Npad), jnp.float32)
            rounds = []
            for _t in range(self.n_trees):
                scores, tree = _rf_group_step(scores, mult, fmask,
                                              query_of_doc,
                                              binned_T, labels_dev,
                                              n_bins=B,
                                              n_leaves=self.n_leaves, lr=lr)
                rounds.append(tree)
            rounds = jax.device_get(rounds)             # one sync per group
            for c in range(n_real):
                ens = TreeEnsemble()
                for tf, tb, tl, tr, tlf, tn, out in rounds:
                    ens.add(_export_tree(tf[c], tb[c], tl[c], tr[c],
                                         tlf[c], out[c], int(tn[c]),
                                         thresholds),
                            lr)
                self.ensembles.append(ens)
                if not silent:
                    m = _bag_train_metric(ens, bag_samples[lo + c],
                                          bag_idx[lo + c], qptr, binned,
                                          thresholds, stream, scorer)
                    log(f"bag {lo + c + 1:<5}| {scorer.name}-bag: {m:.4f}")
        self._merged = None

    def _fit_bags_rebuild(self, train: Dataset, scorer: MetricScorer,
                          mesh, feature_mask: np.ndarray | None = None
                          ) -> None:
        """Mesh path: each bag trains through the full (distributed)
        LambdaMART/MART fit on its sampled subset, sharing the global
        binning via ``prebinned``."""
        from ranklib_tpu.gbdt.binning import bin_features
        from ranklib_tpu.models.gbdt import flatten_binned

        rng = np.random.default_rng(self.seed)
        cls = MART if self.ranker_type == 0 else LambdaMART
        log("Training starts...")
        stream = getattr(train, "binned", None) is not None
        feats_full, _, qptr, thresholds, binned_full, _, _ = (
            flatten_binned(train, self.n_threshold))
        if binned_full is None:
            # NO doc padding here: each bag's sub-fit pads its own subset
            binned_full = bin_features(feats_full, thresholds)
        self.ensembles = []
        was_silent = is_silent()
        for bag in range(self.n_bags):
            sampled, _, qidx = sample_queries(train, self.sub_sampling_rate,
                                              rng)
            fids = sample_features(train.n_features,
                                   self.feature_sampling_rate, rng)
            fmask = np.zeros(train.n_features, bool)
            fmask[[f - 1 for f in fids]] = True
            if feature_mask is not None:
                fmask &= feature_mask
            rows = np.concatenate(
                [np.arange(qptr[i], qptr[i + 1]) for i in qidx])
            ranker = cls(n_trees=self.n_trees, n_leaves=self.n_leaves,
                         learning_rate=self.learning_rate, early_stop=0,
                         n_threshold=self.n_threshold)
            set_silent(True)          # per-bag round tables are noise
            try:
                ranker.fit(sampled, scorer, mesh=mesh, feature_mask=fmask,
                           prebinned=(thresholds, binned_full[rows]))
            finally:
                set_silent(was_silent)
            self.ensembles.append(ranker.ensemble)
            if not was_silent:
                m = (_bag_train_metric(ranker.ensemble, sampled, qidx,
                                       qptr, binned_full, thresholds,
                                       True, scorer)
                     if stream else
                     self._bag_metric(sampled, scorer, ranker))
                log(f"bag {bag + 1:<5}| {scorer.name}-bag: {m:.4f}")
        self._merged = None

    @staticmethod
    def _bag_metric(ds, scorer, ranker) -> float:
        from ranklib_tpu.metrics.base import score_dataset
        return score_dataset(scorer, ds, ranker.eval_dataset(ds))[0]

    # ---- scoring ---------------------------------------------------------
    def _merged_ensemble(self) -> TreeEnsemble:
        """All bags in one packed ensemble, tree weights scaled by 1/nBags
        (score = mean over bags, ref: RFRanker.eval)."""
        if self._merged is None:
            if not self.ensembles:
                raise RankLibError("Model not trained/loaded")
            merged = TreeEnsemble()
            inv = 1.0 / len(self.ensembles)
            for ens in self.ensembles:
                for tree, w in zip(ens.trees, ens.weights):
                    merged.add(tree, w * inv)
            self._merged = merged
        return self._merged

    def eval_dataset(self, ds: Dataset):
        from ranklib_tpu.models.gbdt import (_eval_binned, flatten_meta,
                                             eval_ensemble_dataset)

        if getattr(ds, "binned", None) is not None:
            # streaming -sparse dataset: bin-space eval (exact — this
            # model was trained on this grid), like MART/LambdaMART
            flat = _eval_binned(
                self._merged_ensemble().to_bin_space(ds.thresholds),
                ds.binned)
            _, qptr = flatten_meta(ds)
            return [flat[qptr[i]: qptr[i + 1]]
                    for i in range(len(ds.queries))]
        return eval_ensemble_dataset(self._merged_ensemble(), ds)

    # ---- serialization -----------------------------------------------------
    def model_str(self) -> str:
        head = model_header(self.NAME, {
            "No. of bags": len(self.ensembles),
            "Sub-sampling": self.sub_sampling_rate,
            "Feature-sampling": self.feature_sampling_rate,
            "No. of trees": self.n_trees,
            "No. of leaves": self.n_leaves,
            "Learning rate": self.learning_rate,
        })
        return head + "\n" + "\n".join(e.to_text() for e in self.ensembles)

    def load_str(self, text: str) -> None:
        params, _ = parse_model_params(text)
        if "No. of bags" in params:
            self.n_bags = int(params["No. of bags"])
        self.ensembles = parse_ensembles(text)
        if not self.ensembles:
            raise RankLibError("No <ensemble> blocks in Random Forests model")
        self._merged = None


def parse_ensembles(text: str) -> list[TreeEnsemble]:
    """All <ensemble> blocks in a model text, in order."""
    out = []
    pos = 0
    while True:
        start = text.find("<ensemble>", pos)
        if start < 0:
            break
        end = text.find("</ensemble>", start)
        if end < 0:
            raise RankLibError("Unterminated <ensemble> block")
        end += len("</ensemble>")
        out.append(TreeEnsemble.from_text(text[start:end]))
        pos = end
    return out
