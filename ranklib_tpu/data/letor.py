"""LETOR / SVMLight-with-qid parser and writer.

Line format (ref: learning/DataPoint.java:~120):

    <label> qid:<qid> <fid>:<val> <fid>:<val> ... # <description>

* labels are graded relevance floats (0..gmax);
* feature ids are 1-indexed, need not be contiguous or sorted;
* docs of one query must be CONSECUTIVE lines (qid order across the file is
  free, but a qid may not be interleaved — ref: FeatureManager.readInput,
  features/FeatureManager.java:~60 groups consecutive same-qid lines);
* unspecified fids read as 0 with ``missing_zero`` (CLI ``-missingZero``),
  otherwise they are an error (the reference's default);
* ``#`` starts a description kept verbatim for re-ranking output;
* gzip files are handled transparently.

The reference keeps per-doc objects (Dense/SparseDataPoint); here we go
straight to dense per-query float32 matrices — sparsity is an IO concern
only (SURVEY.md §7: MSLR is dense).
"""

from __future__ import annotations

import numpy as np

from ranklib_tpu.data.dataset import Dataset, Query
from ranklib_tpu.utils.errors import RankLibError
from ranklib_tpu.utils.io import open_text
from ranklib_tpu.utils.logging import log


def _desc_pos(line: str) -> int:
    """Index of the '#' starting the description, or -1. Only a '#' at a
    TOKEN BOUNDARY (line start or after whitespace) starts a description
    — the native parser's rule; a '#' embedded in a qid or value token
    is part of that token, and both parsers must agree."""
    pos = line.find("#")
    while pos > 0 and not line[pos - 1].isspace():
        pos = line.find("#", pos + 1)
    return pos


def _parse_line(line: str):
    """Parse one LETOR line → (label, qid, fids, vals, description)."""
    desc = ""
    hash_pos = _desc_pos(line)
    if hash_pos >= 0:
        desc = line[hash_pos:].rstrip()
        line = line[:hash_pos]
    toks = line.split()
    if len(toks) < 2:
        raise RankLibError(f"Unparseable LETOR line: {line!r}")
    try:
        label = float(toks[0])
    except ValueError as e:
        raise RankLibError(f"Bad relevance label in line: {line!r}") from e
    if label < 0:
        raise RankLibError("Relevance label cannot be negative: " + line)
    if not toks[1].startswith("qid:"):
        raise RankLibError(f"Missing qid in line: {line!r}")
    qid = toks[1][4:]
    fids = []
    vals = []
    for t in toks[2:]:
        c = t.find(":")
        if c <= 0:
            raise RankLibError(f"Bad feature token {t!r} in line: {line!r}")
        # wrap both conversions: the native parser defers malformed
        # input here FOR the precise message (a bare ValueError escaped
        # the CLI's RankLibError handler — review finding; the sparse
        # parser already wrapped both)
        try:
            fid = int(t[:c])
        except ValueError:
            raise RankLibError(
                f"Bad feature id in token {t!r}: {line!r}") from None
        if fid <= 0:
            raise RankLibError(f"Feature id must be >= 1, got {fid}: {line!r}")
        fids.append(fid)
        try:
            vals.append(float(t[c + 1:]))
        except ValueError:
            raise RankLibError(
                f"Bad feature value in token {t!r}: {line!r}") from None
    return label, qid, fids, vals, desc


def read_letor(path: str, must_have_rel_doc: bool = False,
               n_features: int | None = None, quiet: bool = False,
               use_native: bool = True, missing_zero: bool = True) -> Dataset:
    """Read a LETOR file into a :class:`Dataset`.

    ``must_have_rel_doc`` drops queries with no relevant (label>0) document
    (ref: Evaluator's ``mustHaveRelDoc``, set when a train metric requires
    relevance). ``n_features`` pre-pins the feature-vector width (otherwise
    the global max fid in the file defines it, like DataPoint.featureCount).

    ``missing_zero=False`` reproduces the reference's strict semantics
    (ref: learning/DataPoint.java:~120 — `missingZero` static, default
    off): a line that does not specify every fid 1..max_fid is an error.
    Training touches every feature of every doc, so the reference's lazy
    access-time error is equivalent to this eager parse-time check. The
    CLI passes `-missingZero` through; the library default stays
    permissive (missing fids read 0) for programmatic use.

    Plain files go through the native C++ parser when available
    (ranklib_tpu.native — MSLR-scale files parse in seconds instead of
    minutes); gzip inputs, missing compilers, and malformed files fall
    back to this Python parser, which also owns the precise error
    messages.
    """
    if use_native:
        from ranklib_tpu.native.loader import NativeParseError, native_parse_letor
        parsed = None
        try:
            parsed = native_parse_letor(path, want_descs=True,
                                        min_features=n_features or 0)
        except NativeParseError:
            parsed = None      # re-parse in Python for the exact error
        except OSError:
            parsed = None
        if parsed is not None:
            labels, feats, qptr, qids, descs, counts, file_max_fid = parsed
            if not missing_zero:
                _check_fully_specified(path, counts, file_max_fid, qptr, qids)
            return _from_arrays(path, labels, feats, qptr, qids, descs,
                                must_have_rel_doc, quiet)

    raw = []  # (qid, labels, fid_lists, val_lists, descs) per query, file order
    max_fid = 0
    cur_qid = None
    cur = None
    n_lines = 0
    with open_text(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            label, qid, fids, vals, desc = _parse_line(line)
            n_lines += 1
            if fids:
                m = max(fids)
                if m > max_fid:
                    max_fid = m
            if qid != cur_qid:
                cur = ([], [], [], [])
                raw.append((qid, cur))
                cur_qid = qid
            cur[0].append(label)
            cur[1].append(fids)
            cur[2].append(vals)
            cur[3].append(desc)
    if not missing_zero:
        # raw PAIR count, not distinct fids — the native check (and the
        # reference) counts pairs, where a duplicated fid masks a miss;
        # both parsers must accept/reject the same files
        for qid, (_, fid_lists, _, _) in raw:
            for fids in fid_lists:
                if len(fids) < max_fid:
                    _raise_missing(path, qid, fids, max_fid)
    if n_features is not None:
        max_fid = max(max_fid, int(n_features))
    queries = []
    n_dropped = 0
    for qid, (labels, fid_lists, val_lists, descs) in raw:
        labels_arr = np.asarray(labels, dtype=np.float32)
        if must_have_rel_doc and not (labels_arr > 0).any():
            n_dropped += 1
            continue
        n = len(labels)
        feats = np.zeros((n, max_fid), dtype=np.float32)
        for i, (fids, vals) in enumerate(zip(fid_lists, val_lists)):
            if fids:
                feats[i, np.asarray(fids, dtype=np.int64) - 1] = vals
        queries.append(Query(qid=qid, labels=labels_arr, feats=feats, descs=descs))
    if not queries:
        raise RankLibError(f"No queries read from {path}")
    if not quiet:
        log(f"Reading feature file [{path}]... [Done.]")
        log(f"({len(queries)} ranked lists, {sum(q.n for q in queries)} entries read)")
        if n_dropped:
            log(f"({n_dropped} queries with no relevant documents dropped)")
    return Dataset(queries=queries, n_features=max_fid)


def _raise_missing(path, qid, fids, max_fid):
    have = set(fids)
    missing = next(f for f in range(1, max_fid + 1) if f not in have)
    raise RankLibError(
        f"{path}: qid {qid} does not specify feature {missing} "
        f"(features run 1..{max_fid}); unspecified features are an error "
        f"unless -missingZero is given "
        f"(ref: learning/DataPoint.java missingZero)")


def _check_fully_specified(path, counts, max_fid, qptr, qids):
    """Strict missing-feature check on the native parse: every line must
    carry max_fid fid:val pairs (duplicate fids on one line would mask a
    miss — the reference doesn't detect that case either)."""
    bad = np.flatnonzero(counts < max_fid)
    if bad.size:
        doc = int(bad[0])
        qi = int(np.searchsorted(qptr, doc, side="right") - 1)
        raise RankLibError(
            f"{path}: qid {qids[qi]} specifies only {int(counts[doc])} of "
            f"{max_fid} features; unspecified features are an error unless "
            f"-missingZero is given (ref: learning/DataPoint.java "
            f"missingZero)")


def _from_arrays(path, labels, feats, qptr, qids, descs,
                 must_have_rel_doc, quiet) -> Dataset:
    """Native-parser arrays → Dataset (same semantics as the Python path)."""
    queries = []
    n_dropped = 0
    for i, qid in enumerate(qids):
        s, e = int(qptr[i]), int(qptr[i + 1])
        lab = labels[s:e]
        if must_have_rel_doc and not (lab > 0).any():
            n_dropped += 1
            continue
        queries.append(Query(
            qid=qid, labels=lab, feats=feats[s:e],
            descs=list(descs[s:e]) if descs is not None else []))
    if not queries:
        raise RankLibError(f"No queries read from {path}")
    if not quiet:
        log(f"Reading feature file [{path}]... [Done.]")
        log(f"({len(queries)} ranked lists, "
            f"{sum(q.n for q in queries)} entries read)")
        if n_dropped:
            log(f"({n_dropped} queries with no relevant documents dropped)")
    return Dataset(queries=queries, n_features=feats.shape[1])


def read_descs(path: str, n_docs: int | None = None) -> list:
    """Per-data-line '#' descriptions ('' when absent), file order.

    The side-pass the sparse loaders (CSR / streamed-bin) use to carry
    docids for ``-qrel`` / ``-indri`` without materializing features
    (ref: learning/SparseDataPoint.java:~15 keeps the description
    alongside the sparse fid/val arrays). Native when available,
    streamed Python otherwise (gzip inputs and oversized tokens land
    here). Verbatim '#...' strings, matching the dense parsers."""
    if n_docs is not None and not path.endswith(".gz"):
        from ranklib_tpu.native.loader import (
            NativeParseError, native_letor_descs,
        )
        try:
            descs = native_letor_descs(path, n_docs)
        except (NativeParseError, OSError):
            descs = None
        if descs is not None:
            return descs
    descs = []
    with open_text(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            hp = _desc_pos(s)            # token-boundary '#' (native rule)
            descs.append(s[hp:].rstrip() if hp >= 0 else "")
    if n_docs is not None and len(descs) != n_docs:
        raise RankLibError(
            f"{path}: desc pass saw {len(descs)} data lines, "
            f"expected {n_docs}")
    return descs


def write_letor(ds: Dataset, path: str) -> None:
    """Write a Dataset back out in LETOR format (dense fids 1..F)."""
    with open(path, "w") as f:
        for q in ds.queries:
            for i in range(q.n):
                feats = " ".join(
                    f"{fid}:{q.feats[i, fid - 1]:g}" for fid in range(1, ds.n_features + 1)
                )
                desc = (" " + q.descs[i]) if q.descs and q.descs[i] else ""
                f.write(f"{q.labels[i]:g} qid:{q.qid} {feats}{desc}\n")
