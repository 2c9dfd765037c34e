"""Flat tree ensembles: vectorized traversal + RankLib model-file format.

The reference stores trees as object graphs and serializes them as the
``<ensemble><tree id=.. weight=..><split>…`` XML-ish text
(ref: learning/tree/Ensemble.java:~100, learning/tree/Split.java
serialization). Our trees are flat slot arrays (feature/threshold/left/
right/output per node); traversal is a vectorized pointer chase — one
gather per depth level over all docs × all trees, instead of per-DataPoint
virtual calls (ref: Ensemble.eval = Σ weight·tree.eval).

Save/load parity goal (SURVEY.md §5 checkpoint row): a model we save loads
in RankLib and vice versa. Feature ids in the file are 1-indexed fids.
"""

from __future__ import annotations

import functools
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np

from ranklib_tpu.utils.errors import RankLibError


class Tree:
    """One tree in flat-slot form (host numpy). Slot 0 = root."""

    __slots__ = ("feature", "threshold", "left", "right", "is_leaf", "output")

    def __init__(self, feature, threshold, left, right, is_leaf, output):
        self.feature = np.asarray(feature, np.int32)      # 0-based column
        self.threshold = np.asarray(threshold, np.float32)
        self.left = np.asarray(left, np.int32)
        self.right = np.asarray(right, np.int32)
        self.is_leaf = np.asarray(is_leaf, bool)
        self.output = np.asarray(output, np.float32)

    @property
    def n_slots(self):
        return len(self.feature)

    def depth(self) -> int:
        best = 0
        stack = [(0, 0)]                  # iterative: chain trees can
        while stack:                      # exceed the recursion limit
            node, d = stack.pop()
            if self.is_leaf[node]:
                best = max(best, d)
            else:
                stack.append((int(self.left[node]), d + 1))
                stack.append((int(self.right[node]), d + 1))
        return best


class TreeEnsemble:
    """List of (Tree, weight); weight = learning rate for boosted models
    (ref: Ensemble.add(tree, learningRate))."""

    def __init__(self):
        self.trees: list[Tree] = []
        self.weights: list[float] = []
        self._invalidate()

    def _invalidate(self):
        """Drop the cached device packs after the tree list changes."""
        self._packed = None
        self._mm = None
        self._mmk = None

    def add(self, tree: Tree, weight: float):
        self.trees.append(tree)
        self.weights.append(float(weight))
        self._invalidate()

    def truncate(self, n: int):
        """Keep the first n trees (validation-best rollback,
        ref: LambdaMART learn() post-loop truncation)."""
        self.trees = self.trees[:n]
        self.weights = self.weights[:n]
        self._invalidate()

    def __len__(self):
        return len(self.trees)

    def to_bin_space(self, thresholds: np.ndarray) -> "TreeEnsemble":
        """Rewrite every split threshold t on feature f into its bin id
        ``b = searchsorted(thresholds[f], t, 'left')`` so the ensemble
        evaluates EXACTLY on a bin matrix: ``value <= t ⟺ bin <= b``
        whenever t is a grid point — true by construction for ensembles
        trained with this grid (the streaming ``-sparse`` path, which
        keeps no raw feature values to evaluate on). Raises when a split
        threshold is not on the grid (e.g. a model loaded from elsewhere)
        — that model needs the dense pipeline."""
        out = TreeEnsemble()
        B = thresholds.shape[1]
        for tree, w in zip(self.trees, self.weights):
            split = ~tree.is_leaf
            rows = thresholds[tree.feature]                  # [S, B]
            b = (rows < tree.threshold[:, None]).sum(axis=1)  # lower_bound
            on_grid = np.take_along_axis(
                rows, np.minimum(b, B - 1)[:, None], axis=1
            )[:, 0] == tree.threshold
            if not np.all(on_grid[split] & (b[split] < B)):
                raise RankLibError(
                    "ensemble has split thresholds off the binning grid; "
                    "bin-space evaluation needs a model trained with this "
                    "grid (use the dense pipeline instead)")
            thr = np.where(split, b.astype(np.float32), 0.0)
            out.add(Tree(tree.feature, thr, tree.left, tree.right,
                         tree.is_leaf, tree.output), w)
        return out

    # ---- vectorized eval ---------------------------------------------------
    #
    # Matmul-path scoring (the serving path). Pointer-chasing traversal
    # (``_ensemble_eval``) is gather-bound; instead, per chunk of trees:
    #
    #   vals = X[:, fid]      static column gather         [N, TC·M]
    #   pred = vals <= thr    0/1 — exact in bf16
    #   hits = pred @ (P − Q) + colsum(Q)   path agreement [N, TC·L]
    #   ind  = hits == path_len             leaf indicator
    #   score += ind @ outw
    #
    # where P/Q encode, per leaf, which internal nodes must test true/false
    # on its root path; p@P + (1−p)@Q ≡ p@(P−Q) + colsum(Q) is ONE path
    # matmul with (P−Q) ∈ {−1, 0, 1}, still exact in bf16. ``_mm_eval`` is
    # the XLA form (_pack_matmul); on the GPU ops.forest_eval runs the same
    # algebra in one kernel that keeps predicates on chip (_pack_kernel).
    _TREE_CHUNK = 25

    def _tree_dims(self):
        """(max internal nodes M ≥ 1, max leaves L) over the trees."""
        M = max(max((~t.is_leaf).sum(), 1) for t in self.trees)
        L = max(t.is_leaf.sum() for t in self.trees)
        return int(M), int(L)

    def _leaf_paths(self):
        """Per tree: (internal node slots, [(leaf slot, [(node, went_left),
        ...]), ...]) in DFS order — the path structure both packs encode."""
        out = []
        for t in self.trees:
            internal = np.flatnonzero(~t.is_leaf)
            leaves = []
            stack = [(0, [])]
            while stack:
                node, path = stack.pop()
                if t.is_leaf[node]:
                    leaves.append((node, path))
                else:
                    stack.append((int(t.right[node]),
                                  path + [(node, False)]))
                    stack.append((int(t.left[node]), path + [(node, True)]))
            out.append((internal, leaves))
        return out

    def _pack_matmul(self, n_features: int):
        key = ("mm", n_features)
        if getattr(self, "_mm", None) is None or self._mm[0] != key:
            T = len(self.trees)
            M, L = self._tree_dims()
            TC = self._TREE_CHUNK
            Tp = ((T + TC - 1) // TC) * TC
            fid = np.zeros((Tp, M), np.int32)
            thr = np.zeros((Tp, M), np.float32)
            P = np.zeros((Tp, M, L), np.float32)
            Q = np.zeros((Tp, M, L), np.float32)
            plen = np.full((Tp, L), -1.0, np.float32)   # pads never match
            outw = np.zeros((Tp, L), np.float32)
            for ti, ((internal, leaves), t, w) in enumerate(
                    zip(self._leaf_paths(), self.trees, self.weights)):
                slot_of = {int(n): i for i, n in enumerate(internal)}
                fid[ti, :len(internal)] = t.feature[internal]
                thr[ti, :len(internal)] = t.threshold[internal]
                for li, (node, path) in enumerate(leaves):
                    for m, left in path:
                        (P if left else Q)[ti, slot_of[m], li] = 1.0
                    plen[ti, li] = len(path)
                    outw[ti, li] = t.output[node] * w
            nch = Tp // TC
            # per-chunk predicate row count padded to a multiple of 16;
            # dead rows are inert (fid 0, thr 0, zero P/Q rows)
            TCM = ((TC * M + 15) // 16) * 16
            # one selection index vector for ALL trees (X is read once),
            # plus chunked dense P/Q blocks for the path matmuls
            fid_full = np.zeros((nch * TCM,), np.int32)
            thr_full = np.zeros((nch * TCM,), np.float32)
            Pc = np.zeros((nch, TCM, TC * L), np.float32)
            Qc = np.zeros((nch, TCM, TC * L), np.float32)
            plenc = np.full((nch, TC * L), -1.0, np.float32)
            outwc = np.zeros((nch, TC * L), np.float32)
            for c in range(nch):
                for j in range(TC):
                    ti = c * TC + j
                    col = c * TCM + j * M
                    fid_full[col: col + M] = fid[ti]
                    thr_full[col: col + M] = thr[ti]
                    Pc[c, j * M:(j + 1) * M, j * L:(j + 1) * L] = P[ti]
                    Qc[c, j * M:(j + 1) * M, j * L:(j + 1) * L] = Q[ti]
                    plenc[c, j * L:(j + 1) * L] = plen[ti]
                    outwc[c, j * L:(j + 1) * L] = outw[ti]
            PmQc = Pc - Qc                      # {-1, 0, 1}
            csQc = Qc.sum(axis=1)               # [nch, TC·L]
            self._mm = (key, tuple(jnp.asarray(a) for a in
                                   (fid_full, thr_full, PmQc, csQc, plenc,
                                    outwc)))
        return self._mm[1]

    def _pack_kernel(self):
        """Operands of ``ops.forest_eval.forest_eval_triton``: chunks of
        TC = _WIDTH // max(M, L) trees, node and leaf axes padded to
        powers of two ≥ 16 (the tensor-core dot's minimum). Per chunk:
        fid/thr [Mp] (dead slots inert: fid 0, zero pmq row), pmq
        [Mp, Lp] bf16 (+1 left edge, −1 right edge), nleft [Lp] (a leaf's
        left-edge count; pad leaves −1, which no hit count equals), outw
        [Lp] (weighted leaf outputs)."""
        if getattr(self, "_mmk", None) is None:
            from ranklib_tpu.ops.forest_eval import _WIDTH

            M, L = self._tree_dims()
            TC = max(1, _WIDTH // max(M, L))
            Mp = max(16, 1 << (TC * M - 1).bit_length())
            Lp = max(16, 1 << (TC * L - 1).bit_length())
            nch = -(-len(self.trees) // TC)
            fid = np.zeros((nch, Mp), np.int32)
            thr = np.zeros((nch, Mp), np.float32)
            pmq = np.zeros((nch, Mp, Lp), np.float32)
            nleft = np.full((nch, Lp), -1.0, np.float32)
            outw = np.zeros((nch, Lp), np.float32)
            for ti, ((internal, leaves), t, w) in enumerate(
                    zip(self._leaf_paths(), self.trees, self.weights)):
                c, j = divmod(ti, TC)
                slot_of = {int(n): j * M + i for i, n in enumerate(internal)}
                fid[c, j * M: j * M + len(internal)] = t.feature[internal]
                thr[c, j * M: j * M + len(internal)] = t.threshold[internal]
                for k, (node, path) in enumerate(leaves):
                    li = j * L + k
                    for m, left in path:
                        pmq[c, slot_of[m], li] = 1.0 if left else -1.0
                    nleft[c, li] = sum(1 for _, left in path if left)
                    outw[c, li] = t.output[node] * w
            self._mmk = (jnp.asarray(fid), jnp.asarray(thr),
                         jnp.asarray(pmq, jnp.bfloat16), jnp.asarray(nleft),
                         jnp.asarray(outw))
        return self._mmk

    def _pack(self):
        if self._packed is None:
            T = len(self.trees)
            M = max(t.n_slots for t in self.trees)
            depth = max(t.depth() for t in self.trees) if T else 0
            feat = np.zeros((T, M), np.int32)
            thr = np.zeros((T, M), np.float32)
            lft = np.zeros((T, M), np.int32)
            rgt = np.zeros((T, M), np.int32)
            leaf = np.ones((T, M), bool)
            out = np.zeros((T, M), np.float32)
            for i, t in enumerate(self.trees):
                m = t.n_slots
                feat[i, :m] = t.feature
                thr[i, :m] = t.threshold
                lft[i, :m] = np.maximum(t.left, 0)
                rgt[i, :m] = np.maximum(t.right, 0)
                leaf[i, :m] = t.is_leaf
                out[i, :m] = t.output
            self._packed = (
                jnp.asarray(feat), jnp.asarray(thr), jnp.asarray(lft),
                jnp.asarray(rgt), jnp.asarray(leaf), jnp.asarray(out),
                jnp.asarray(np.asarray(self.weights, np.float32)), depth,
            )
        return self._packed

    # docs per eval launch. XLA path: bounds the [T·M, chunk] predicate
    # matrix in device memory. Kernel path: nothing but X and the scores
    # is materialized, so the chunk only bounds int32 index arithmetic.
    _EVAL_CHUNK = 1 << 14
    _EVAL_CHUNK_KERNEL = 1 << 20

    def _device_eval_fn(self, n_features: int):
        """(fn, chunk): fn maps a device-resident [n, F] f32 block to
        device scores [n]. Route (ops.routing): the Triton kernel on the
        GPU when the trees fit it, else the XLA ``_mm_eval``."""
        from ranklib_tpu.ops import routing

        if routing.scoring_kernel(*self._tree_dims()):
            from ranklib_tpu.ops.forest_eval import forest_eval_triton

            packed = self._pack_kernel()
            return (lambda X: forest_eval_triton(X, *packed)), \
                self._EVAL_CHUNK_KERNEL
        packed = self._pack_matmul(n_features)
        return (lambda X: _mm_eval(X, *packed)), self._EVAL_CHUNK

    def eval_matrix(self, feats: np.ndarray) -> np.ndarray:
        """feats [N, F] → scores [N] = Σ_t w_t · tree_t(x).

        One host→device upload of the f32 matrix, device-side doc
        chunking, one download."""
        if not self.trees:
            return np.zeros(feats.shape[0], np.float32)
        eval_fn, C = self._device_eval_fn(feats.shape[1])
        Xd = jnp.asarray(feats, jnp.float32)
        N = feats.shape[0]
        if N <= C:
            return np.asarray(eval_fn(Xd))[:N]
        # full C-sized chunks share one compiled program; the tail runs at
        # its true length instead of padding N up to a C multiple
        parts = []
        for lo in range(0, N, C):
            if lo + C <= N:
                parts.append(eval_fn(jax.lax.dynamic_slice_in_dim(Xd, lo, C)))
            else:
                parts.append(eval_fn(Xd[lo:N]))
        return np.asarray(jnp.concatenate(parts))[:N]

    # ---- text format ---------------------------------------------------------
    def to_text(self) -> str:
        lines = ["<ensemble>"]
        for i, (t, w) in enumerate(zip(self.trees, self.weights)):
            lines.append(f"\t<tree id=\"{i + 1}\" weight=\"{w}\">")
            lines.extend(_node_text(t, 0, 2))
            lines.append("\t</tree>")
        lines.append("</ensemble>")
        return "\n".join(lines) + "\n"

    @staticmethod
    def from_text(text: str) -> "TreeEnsemble":
        """Parse the reference's ensemble XML (tolerates whitespace in
        <feature>/<threshold>/<output> text, as RankLib emits)."""
        start = text.find("<ensemble>")
        if start < 0:
            raise RankLibError("No <ensemble> found in model text")
        end = text.find("</ensemble>") + len("</ensemble>")
        try:
            root = ET.fromstring(text[start:end])
        except ET.ParseError as e:
            raise RankLibError(f"Bad ensemble XML: {e}") from e
        ens = TreeEnsemble()
        for tree_el in root.findall("tree"):
            weight = float(tree_el.get("weight", "1.0"))
            split = tree_el.find("split")
            if split is None:
                raise RankLibError("<tree> without <split>")
            nodes = []
            _parse_split(split, nodes)
            ens.add(_tree_from_nodes(nodes), weight)
        return ens


def _node_text(t: Tree, node: int, indent: int, pos: str | None = None):
    """Explicit-stack DFS (leaf-wise growth can produce chain trees of
    depth ~n_leaves; one Python frame per level RecursionError'd at save
    time past ~1000 — review finding, round 5)."""
    lines = []
    stack = [("open", node, indent, pos)]
    while stack:
        kind, nd, ind, ps = stack.pop()
        tab = "\t" * ind
        if kind == "close":
            lines.append(f"{tab}</split>")
            continue
        attr = f" pos=\"{ps}\"" if ps else ""
        lines.append(f"{tab}<split{attr}>")
        if t.is_leaf[nd]:
            lines.append(f"{tab}\t<output> {t.output[nd]:.15f} </output>")
            lines.append(f"{tab}</split>")
        else:
            lines.append(
                f"{tab}\t<feature> {int(t.feature[nd]) + 1} </feature>")
            lines.append(f"{tab}\t<threshold> {t.threshold[nd]} </threshold>")
            stack.append(("close", nd, ind, None))
            stack.append(("open", int(t.right[nd]), ind + 1, "right"))
            stack.append(("open", int(t.left[nd]), ind + 1, "left"))
    return lines


def _parse_split(el, nodes) -> int:
    """Descent over <split> elements → flat node list; returns the root
    slot index. Explicit work stack (files from other tools can carry
    chain trees past the Python recursion limit — review finding);
    pre-order slot assignment matches the old recursion exactly."""
    root_idx = len(nodes)
    stack = [el]
    # pass 1: pre-order slot assignment (parent before left before right)
    order = []
    while stack:
        e = stack.pop()
        idx = len(nodes)
        nodes.append(None)
        order.append((e, idx))
        if e.find("feature") is not None:
            kids = {c.get("pos"): c for c in e.findall("split")}
            if "left" not in kids or "right" not in kids:
                raise RankLibError("Internal <split> missing left/right child")
            stack.append(kids["right"])
            stack.append(kids["left"])
    # pre-order via a LIFO visits parent, then the whole left subtree,
    # then the right subtree — exactly the recursive numbering. Record
    # each element's slot, then fill nodes with child links.
    slot_of = {id(e): idx for e, idx in order}
    for e, idx in order:
        out_el = e.find("output")
        feat_el = e.find("feature")
        if feat_el is not None:
            thr_el = e.find("threshold")
            if thr_el is None or not (thr_el.text or "").strip():
                raise RankLibError("<split> missing <threshold>")
            kids = {c.get("pos"): c for c in e.findall("split")}
            nodes[idx] = (int(feat_el.text.strip()) - 1,
                          float(thr_el.text.strip()),
                          slot_of[id(kids["left"])],
                          slot_of[id(kids["right"])], False, 0.0)
        elif out_el is not None:
            nodes[idx] = (0, 0.0, -1, -1, True, float(out_el.text.strip()))
        else:
            raise RankLibError("<split> with neither children nor <output>")
    return root_idx


def _tree_from_nodes(nodes) -> Tree:
    return Tree(
        [n[0] for n in nodes], [n[1] for n in nodes], [n[2] for n in nodes],
        [n[3] for n in nodes], [n[4] for n in nodes], [n[5] for n in nodes],
    )


@jax.jit
def _mm_eval(X, fid_full, thr_full, PmQc, csQc, plenc, outwc):
    """Gather + path-matmul ensemble scoring (XLA); see _pack_matmul for
    the encoding and the class comment for the algebra.

    X: [N, F]. All predicates come from ONE static row gather of X^T
    (each predicate row reads exactly one feature — exact in f32, no
    matmul rounding to guard against); the single path matmul per tree
    chunk contracts the node axis of the transposed predicate matrix:

        hits = pred @ (P−Q) + colsum(Q)

    equals the path-agreement count pred @ P + (1−pred) @ Q. Numerics:
    `pred` is 0/1, (P−Q) ∈ {−1,0,1} and the counts are small integers
    (≤ path depth ≤ slot count) — all exact in bf16. Only the final
    leaf-output matmul touches real-valued training outputs; it keeps
    HIGHEST precision (it is [N, TC·L]·[TC·L] per chunk — tiny). The
    predicate dtype is ``ops.routing.predicate_dtype()`` (a trace-time
    choice; results are identical either way)."""
    from ranklib_tpu.ops import routing

    pdt = routing.predicate_dtype()
    valsT = jnp.take(X.T, fid_full, axis=0)          # [T·M, N] row gather
    predT = (valsT <= thr_full[:, None]).astype(pdt)
    nch, TCM, _ = PmQc.shape

    def chunk(score, args):
        c, PmQ, csQ, plen, outw = args
        pT = jax.lax.dynamic_slice_in_dim(predT, c * TCM, TCM, axis=0)
        hits = jax.lax.dot_general(
            pT, PmQ.astype(pdt),
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32) + csQ[None, :]
        ind = (hits == plen[None, :]).astype(jnp.float32)
        return score + jnp.dot(ind, outw,
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST), None

    score, _ = jax.lax.scan(
        chunk, jnp.zeros((X.shape[0],), jnp.float32),
        (jnp.arange(nch, dtype=jnp.int32), PmQc, csQc, plenc, outwc))
    return score


@functools.partial(jax.jit, static_argnames=("depth",))
def _ensemble_eval(X, feat, thr, lft, rgt, leaf, out, w, depth: int):
    """X [N, F]; tree arrays [T, M] → scores [N].

    Traversal: per tree, all docs descend in lockstep — `depth` rounds of
    (gather split feature value, compare, select child). Leaves self-loop
    via the is_leaf select.
    """
    N = X.shape[0]

    def one_tree(f_, t_, l_, r_, lf_, o_):
        def body(_, node):
            v = jnp.take_along_axis(X, f_[node][:, None], axis=1)[:, 0]
            nxt = jnp.where(v <= t_[node], l_[node], r_[node])
            return jnp.where(lf_[node], node, nxt)

        node = jax.lax.fori_loop(0, depth, body,
                                 jnp.zeros((N,), jnp.int32))
        return o_[node]

    per_tree = jax.vmap(one_tree)(feat, thr, lft, rgt, leaf, out)   # [T, N]
    # HIGHEST: a default-precision f32 dot may run in TF32 on the GPU,
    # which rounds the leaf outputs of this reference
    return jnp.einsum("t,tn->n", w, per_tree,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
