"""The comparison that decides ``correct``.

Served answers are judged by what they say, against the plain
reference (``reference/ivf_patience.py``), on a sample drawn from the
seed once the window has closed: the answers with the most probes and a
uniform draw of the rest.  Each sampled answer names its query, its
top-k ids and its probe count C.  The numbers compared:

- ``missing``: queries sent in the window that got no answer;
- ``inputs_changed``: 1 if any input both sides read (corpus, layout,
  query pool) differs after the window from what set-up made;
- ``invalid``: sampled answers that name an id twice or an id that is
  no document;
- ``exit_mismatch_pct``: the share of sampled answers whose C is not
  the reference's patience exit, where the reference finds no tie
  within ``tie_tol`` at which the two can part (:func:`partings`): a
  float32 program may break such a tie either way;
- ``gap_share_pct``: the share of sampled answers whose ids fall short
  of the reference's top-k after the same C probes by more than
  ``gap_tol`` in float64 score at some rank: the answer's ids scored in
  float64 and sorted, against the reference's sorted scores.

``probe_mismatch_pct``, the share whose C is not the reference's, ties
or not, and ``score_gap_max``, the widest shortfall, are printed beside
them.  :func:`explain` lists each answer that parts from the reference
with the margins it was judged by.

A live cell (``mutations.py``) is judged against
``reference/ivf_live.py``, which replays the stream's overlay: each
sampled answer against the corpus its own probes saw, from the wave its
query was admitted at.  The tie rule also covers assignment ties: an
added vector whose two nearest centroids lie within ``tie_tol``, on a
list the answer probed.  Three numbers more, the first two over every
answer and not only the sample:

- ``deleted_returned``: answers that hold an id whose delete was
  published before the wave of the answer's last probe;
- ``acked_add_missed``: answers of a planted query, admitted after the
  plant was published, that lack the plant though it was not deleted
  before the wave of the answer's last probe;
- ``schedule_mismatch``: calls whose waves, replayed from their probe
  counts by the scheduler's admission rule (:func:`replay`), are not
  ``report.waves``; the replay also gives each answer its admission
  wave.

A configuration with a ``policy`` block is judged against
``reference/ivf_cascade.py`` with the trees the harness trained
(``policy.py``).  Where the lesser of the two probe counts is ``tau``,
the classifier's reading can set it: the tie rule then looks at the
margins of every probe through ``tau`` (the features read them all), and
also counts as tied a split on the reference's path within ``tree_tol``
of its feature, or a margin within ``tree_tol`` of the threshold's
logit, both on the reference's float64 features.  ``clf_exit_pct``, the
share of sampled queries the reference's classifier exits at ``tau``,
is printed beside the numbers.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .reference import ivf_cascade, ivf_live, ivf_patience

INF = float("inf")


@dataclasses.dataclass
class Answers:
    """Sampled answers: pool rows, (m, k) ids and (m,) probe counts;
    where each came from, (m, 2) call and position; in a live cell, the
    wave of each one's admission over the run."""
    pool_idx: np.ndarray
    ids: np.ndarray
    probes: np.ndarray
    src: Optional[np.ndarray] = None
    admit: Optional[np.ndarray] = None


def sample(calls, n: int, longest: int, seed: int) -> Answers:
    """``longest`` answers of distinct queries with the most probes (one
    answer of each query and ties in a seeded order) and a uniform draw
    of ``n - longest`` of the rest; all of them when there are at most
    ``n``.  Queries without an answer are ``missing``'s to count."""
    rng = np.random.default_rng([seed, 0x5A3F1E])
    where = [(c, j) for c, call in enumerate(calls)
             for j in range(call.pool_idx.shape[0])
             if j in call.report.results and j in call.report.probes]
    probes = np.array([calls[c].report.probes[j] for c, j in where])
    if len(where) <= n:
        pick = np.arange(len(where))
    else:
        pool = np.array([calls[c].pool_idx[j] for c, j in where])
        order = rng.permutation(len(where))
        _, first = np.unique(pool[order], return_index=True)
        one = order[first][rng.permutation(first.shape[0])]
        top = one[np.argsort(-probes[one], kind="stable")][:longest]
        rest = np.setdiff1d(np.arange(len(where)), top)
        pick = np.concatenate(
            [top, rng.choice(rest, n - top.shape[0], replace=False)])
    sel = [where[i] for i in pick]
    return Answers(
        np.array([calls[c].pool_idx[j] for c, j in sel], np.int64),
        np.stack([np.asarray(calls[c].report.results[j]) for c, j in sel]
                 ).astype(np.int64),
        probes[pick].astype(np.int64),
        np.array(sel, np.int64).reshape(-1, 2))


def missing(calls) -> int:
    """Queries sent without an answer (or with a probe count) back."""
    n = 0
    for call in calls:
        want = set(range(call.pool_idx.shape[0]))
        got = set(call.report.results) & set(call.report.probes)
        n += len(want - got)
    return n


def reference_of(corpus, cfg: dict, pool_idx: np.ndarray, *,
                 tf32: bool = False, admit: Optional[np.ndarray] = None,
                 overlay: Optional[ivf_live.Overlay] = None,
                 forest: Optional[ivf_cascade.Forest] = None):
    """The reference over the distinct queries of ``pool_idx``; returns
    it and the row of each of ``pool_idx`` in it.  With an ``overlay``
    (a live cell), the live reference of each query admitted at its
    wave of ``admit``, a row each.  A configuration with a ``policy``
    block takes the cascade reference with the trees ``forest``."""
    if overlay is not None:
        dev = corpus.pool.device
        ref = ivf_live.search(
            corpus.pool[torch.as_tensor(pool_idx, device=dev)],
            torch.as_tensor(admit, device=dev), corpus.docs,
            corpus.doc_ids, corpus.offsets, corpus.sizes, corpus.centroids,
            overlay, k=cfg["k"], n_probe=cfg["n_probe"],
            delta=cfg["patience_delta"], phi=cfg["patience_phi"],
            list_pad=cfg["list_pad"], chunk=cfg["chunk"], tf32=tf32)
        return ref, np.arange(pool_idx.shape[0])
    uniq, inv = np.unique(pool_idx, return_inverse=True)
    q = corpus.pool[torch.as_tensor(uniq, device=corpus.pool.device)]
    if "policy" in cfg:
        pol = cfg["policy"]
        ref = ivf_cascade.search(
            q, corpus.docs, corpus.doc_ids, corpus.offsets, corpus.sizes,
            corpus.centroids, forest, k=cfg["k"], n_probe=cfg["n_probe"],
            delta=cfg["patience_delta"], phi=cfg["patience_phi"],
            tau=pol["tau"], threshold=pol["clf_threshold"],
            list_pad=cfg["list_pad"], tf32=tf32)
        return ref, inv
    ref = ivf_patience.search(
        q, corpus.docs, corpus.doc_ids, corpus.offsets, corpus.sizes,
        corpus.centroids, k=cfg["k"], n_probe=cfg["n_probe"],
        delta=cfg["patience_delta"], phi=cfg["patience_phi"],
        list_pad=cfg["list_pad"], tf32=tf32)
    return ref, inv


def control_answers(corpus, cfg: dict, pool_idx: np.ndarray, *,
                    admit: Optional[np.ndarray] = None,
                    overlay: Optional[ivf_live.Overlay] = None,
                    forest: Optional[ivf_cascade.Forest] = None
                    ) -> Answers:
    """The control: the reference in TF32 put in the program's place,
    its answers at its own exit."""
    ref, inv = reference_of(corpus, cfg, pool_idx, tf32=True, admit=admit,
                            overlay=overlay, forest=forest)
    rows = torch.arange(ref.probes.shape[0], device=ref.probes.device)
    ids = ref.ids[rows, ref.probes - 1].cpu().numpy()
    return Answers(pool_idx, ids[inv], ref.probes.cpu().numpy()[inv],
                   admit=admit)


def _judged(corpus, cfg: dict, ans: Answers, ref, inv: np.ndarray,
            block: int = 1024, overlay: Optional[ivf_live.Overlay] = None):
    """Per sampled answer: invalid, its probe count out of range, and
    its score shortfall against the reference's top-k after its own C
    probes (inf where it is invalid or out of range)."""
    dev = corpus.docs.device
    m, k = ans.ids.shape
    n_ids = corpus.n_docs if overlay is None else overlay.n_ids
    bad = (ans.ids < -1) | (ans.ids >= n_ids)
    srt = np.sort(np.where(ans.ids >= 0, ans.ids, -1 - np.arange(k)), 1)
    invalid = bad.any(1) | (srt[:, 1:] == srt[:, :-1]).any(1)
    probes_ok = (ans.probes >= 1) & (ans.probes <= cfg["n_probe"])
    gaps = np.full(m, INF)
    ok = ~invalid & probes_ok
    for s in range(0, m, block):
        sel = np.nonzero(ok[s:s + block])[0] + s
        if not sel.size:
            continue
        rows = torch.as_tensor(inv[sel], device=dev)
        at = torch.as_tensor(ans.probes[sel] - 1, device=dev)
        want = ref.scores[rows, at]                      # (b, k) sorted
        ids = torch.as_tensor(ans.ids[sel], device=dev)
        q = corpus.pool[torch.as_tensor(ans.pool_idx[sel], device=dev)]
        got = ivf_patience.doc_scores(q, corpus.docs, corpus.id_rows,
                                      ids) if overlay is None else \
            ivf_live.doc_scores(q, corpus.docs, corpus.id_rows, overlay, ids)
        got = torch.sort(got, dim=1, descending=True).values
        short = torch.where(torch.isinf(want) & (want < 0),
                            torch.zeros_like(want), want - got)
        gaps[sel] = short.clamp(min=0).amax(1).cpu().numpy()
    return invalid, probes_ok, gaps


def stage_gaps(cfg: dict, ref, inv: np.ndarray) -> Optional[np.ndarray]:
    """For a configuration with a ``policy`` block, per answer: how near
    the reference's classifier stage is a tie, the lesser of its nearest
    split (``split_gap``) and its margin's distance from the threshold's
    logit; None for any other configuration."""
    if "policy" not in cfg:
        return None
    thr = cfg["policy"]["clf_threshold"]
    cut = math.log(thr / (1.0 - thr))
    gap = torch.minimum(ref.split_gap, (ref.margin.double() - cut).abs())
    return gap.cpu().numpy()[inv]


def partings(corpus, cfg: dict, ans: Answers, ref_probes: np.ndarray,
             sel: np.ndarray, overlay: Optional[ivf_live.Overlay] = None,
             stage_gap: Optional[np.ndarray] = None
             ) -> Dict[str, np.ndarray]:
    """Where the answers ``sel`` can part from the reference, and how
    near a tie the reference is there (``ivf_patience.margins``).

    With ``m`` the lesser of the two probe counts, one side counted
    phi >= Phi at a probe of ``[m - Delta, m)`` where the other did not,
    or both probed the same number of lists but not the same lists.
    ``kept`` at those probes depends on the top-k after probes
    ``[lo, m)``, ``lo = m - Delta - 1``, and on the probe order through
    rank ``m``.  So: ``boundary``, the narrowest k-th-boundary margin over
    ``[lo, m)``, and ``centroid``, the narrowest gap between neighbouring
    centroid scores over ranks ``[0, m)``, each with where it lies
    (``*_at``), and ``tied``: either under ``tie_tol``.  With an
    ``overlay``, the margins of the corpus each probe saw, and
    ``assign_tie``: an add of the overlay whose two nearest centroids
    lie within ``tie_tol``, on a list among the answer's first
    max(C, reference's C) probes, published before its last probe's
    wave; ``tied`` then counts it too.  With a ``stage_gap`` (a policy
    configuration, :func:`stage_gaps`) and ``m`` equal to ``tau``:
    ``lo`` is 0, since the classifier read the top-k after every probe
    through ``tau``, ``stage`` is the answer's stage gap, and ``tied``
    also counts it under ``tree_tol``."""
    dev = corpus.docs.device
    q = corpus.pool[torch.as_tensor(ans.pool_idx[sel], device=dev)]
    if overlay is None:
        mg = ivf_patience.margins(
            q, corpus.docs, corpus.doc_ids, corpus.offsets, corpus.sizes,
            corpus.centroids, k=cfg["k"], n_probe=cfg["n_probe"],
            list_pad=cfg["list_pad"])
    else:
        mg = ivf_live.margins(
            q, torch.as_tensor(ans.admit[sel], device=dev), corpus.docs,
            corpus.doc_ids, corpus.offsets, corpus.sizes, corpus.centroids,
            overlay, k=cfg["k"], n_probe=cfg["n_probe"],
            list_pad=cfg["list_pad"], chunk=cfg["chunk"])
    bnd, cen = mg.boundary.cpu().numpy(), mg.centroid.cpu().numpy()
    m = np.minimum(ans.probes[sel], ref_probes[sel])
    lo = np.maximum(0, m - cfg["patience_delta"] - 1)
    at_stage = np.zeros(sel.shape[0], bool)
    if stage_gap is not None:
        at_stage = m == cfg["policy"]["tau"]
        lo = np.where(at_stage, 0, lo)
    out = {key: np.zeros(sel.shape[0], dtype) for key, dtype in (
        ("lo", np.int64), ("boundary", float), ("boundary_at", np.int64),
        ("centroid", float), ("centroid_at", np.int64))}
    for r in range(sel.shape[0]):
        b, c = bnd[r, lo[r]:m[r]], cen[r, :m[r]]
        out["lo"][r] = lo[r]
        out["boundary"][r], out["boundary_at"][r] = b.min(), lo[r] + b.argmin()
        out["centroid"][r], out["centroid_at"][r] = c.min(), c.argmin()
    tol = cfg["check"]["tie_tol"]
    out["tied"] = (out["boundary"] < tol) | (out["centroid"] < tol)
    if stage_gap is not None:
        out["stage"] = np.where(at_stage, stage_gap[sel], INF)
        out["tied"] |= out["stage"] < cfg["check"]["tree_tol"]
    if overlay is not None:
        most = np.maximum(ans.probes[sel], ref_probes[sel])
        out["assign_tie"] = assignment_ties(
            corpus, cfg, overlay, q, ans.admit[sel], most, tol)
        out["tied"] |= out["assign_tie"]
    return out


def assignment_ties(corpus, cfg: dict, overlay: ivf_live.Overlay, q,
                    admit: np.ndarray, probes: np.ndarray, tol: float
                    ) -> np.ndarray:
    """Which of the queries ``q``, admitted at ``admit`` and probing
    their first ``probes`` lists, probed a list of an add whose two
    nearest centroids lie within ``tol``, published before the last of
    those probes' wave."""
    out = np.zeros(q.shape[0], bool)
    lists, margin, runner = ivf_live.assign(overlay.vecs, corpus.centroids)
    tied = torch.nonzero(margin < tol)[:, 0]
    if not tied.numel() or not q.shape[0]:
        return out
    pair = torch.stack([lists[tied], runner[tied]], 1).cpu().numpy()
    added = overlay.added[tied].cpu().numpy()
    order = ivf_patience.centroid_order(q, corpus.centroids,
                                        cfg["n_probe"]).cpu().numpy()
    last = admit + (probes - 1) // cfg["chunk"]
    for r in range(q.shape[0]):
        seen = np.isin(pair, order[r, :probes[r]]).any(1)
        out[r] = bool((seen & (added < last[r])).any())
    return out


def compare(corpus, cfg: dict, ans: Answers, ref, inv: np.ndarray,
            overlay: Optional[ivf_live.Overlay] = None) -> Dict[str, float]:
    """The answer-by-answer numbers (see the module's docstring); with
    an ``overlay``, also ``assign_tied``, the mismatches only an
    assignment tie excuses, and with a ``policy`` block
    ``clf_exit_pct`` (both printed only)."""
    invalid, probes_ok, gaps = _judged(corpus, cfg, ans, ref, inv,
                                       overlay=overlay)
    ref_probes = ref.probes.cpu().numpy()[inv]
    mismatch = ref_probes != ans.probes
    untied = mismatch & ~probes_ok
    sel = np.nonzero(mismatch & probes_ok)[0]
    part = None
    stage = stage_gaps(cfg, ref, inv)
    if sel.size:
        part = partings(corpus, cfg, ans, ref_probes, sel, overlay, stage)
        untied[sel] = ~part["tied"]
    out = {
        "invalid": int(invalid.sum() + (~probes_ok).sum()),
        "exit_mismatch_pct": 100.0 * float(untied.mean()),
        "gap_share_pct": 100.0 * float(
            (gaps > cfg["check"]["gap_tol"]).mean()),
        "probe_mismatch_pct": 100.0 * float(mismatch.mean()),
        "score_gap_max": float(gaps.max()) if gaps.size else 0.0,
    }
    if stage is not None:
        out["clf_exit_pct"] = 100.0 * float(
            ref.clf_exit.cpu().numpy()[inv].mean())
    if overlay is not None:
        out["assign_tied"] = 0 if part is None else int(
            (part["assign_tie"] & (part["boundary"] >= cfg["check"]["tie_tol"])
             & (part["centroid"] >= cfg["check"]["tie_tol"])).sum())
    return out


def explain(corpus, cfg: dict, ans: Answers, ref, inv: np.ndarray,
            overlay: Optional[ivf_live.Overlay] = None) -> List[dict]:
    """Each sampled answer whose C is not the reference's, or whose ids
    fall short of the reference's top-k by more than ``gap_tol``, with
    the reference's ``kept`` after each probe from ``lo`` to the greater
    C, the margins of :func:`partings` (with a ``policy`` block, its
    stage gap too) and the answer's score shortfall."""
    _, _, gaps = _judged(corpus, cfg, ans, ref, inv, overlay=overlay)
    ref_probes = ref.probes.cpu().numpy()[inv]
    bad = np.nonzero(np.isfinite(gaps) & (
        (ref_probes != ans.probes) | (gaps > cfg["check"]["gap_tol"])))[0]
    if not bad.size:
        return []
    part = partings(corpus, cfg, ans, ref_probes, bad, overlay,
                    stage_gaps(cfg, ref, inv))
    out = []
    for r, i in enumerate(bad):
        cp, cr = int(ans.probes[i]), int(ref_probes[i])
        top = ref.ids[inv[i]].cpu().numpy()                   # (N, k)
        kept = [int(np.intersect1d(top[h - 1][top[h - 1] >= 0],
                                   top[h]).size) if h else 0
                for h in range(int(part["lo"][r]), max(cp, cr))]
        out.append({
            "pool_row": int(ans.pool_idx[i]), "program_probes": cp,
            "reference_probes": cr, "kept_from_probe": int(part["lo"][r]),
            "reference_kept": kept,
            "boundary_margin_min": float(part["boundary"][r]),
            "boundary_margin_at": int(part["boundary_at"][r]),
            "centroid_gap_min": float(part["centroid"][r]),
            "centroid_gap_at": int(part["centroid_at"][r]),
            "tied": bool(part["tied"][r]),
            "score_gap": float(gaps[i])})
        if "stage" in part:
            out[-1]["stage_gap"] = float(part["stage"][r])
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> List[str]:
    """The numbers that pass their limits' upper ends: none means
    correct.  A number with no limit is printed only."""
    return [n for n, lim in limits.items()
            if not numbers.get(n, INF) <= lim]


def replay(probes: np.ndarray, lanes: int, chunk: int
           ) -> Tuple[np.ndarray, int]:
    """The scheduler's admission rule, replayed from a call's probe
    counts in qid order: ``lanes`` lanes; at the top of each wave the
    queued queries fill the free lanes in qid order; a query of p probes
    holds its lane for ceil(p / chunk) waves; the call ends at the first
    wave with no lane busy and none queued.  Returns the wave (1-based,
    of the call) each query was admitted at, and the call's waves."""
    n = probes.shape[0]
    hold = np.maximum(-(-probes // chunk), 1)
    admit = np.zeros(n, np.int64)
    ends: Dict[int, int] = collections.Counter()
    busy = nxt = wave = 0
    while True:
        wave += 1
        busy -= ends.pop(wave, 0)
        take = min(lanes - busy, n - nxt)
        if take > 0:
            admit[nxt:nxt + take] = wave
            e, c = np.unique(wave + hold[nxt:nxt + take], return_counts=True)
            for x, y in zip(e.tolist(), c.tolist()):
                ends[x] += y
            busy += take
            nxt += take
        if not busy and nxt >= n:
            return admit, wave - 1


def schedule(calls, cfg: dict) -> Tuple[List[np.ndarray], int]:
    """Each call's admission waves over the run (:func:`replay` after the
    call's first wave) and ``schedule_mismatch``, the calls whose
    replayed waves are not ``report.waves``."""
    admits, bad = [], 0
    for call in calls:
        n = call.pool_idx.shape[0]
        p = np.array([call.report.probes.get(j, 0) for j in range(n)],
                     np.int64)
        a, waves = replay(p, cfg["wave_size"], cfg["chunk"])
        bad += int(waves != call.report.waves)
        admits.append(call.mutations["first_wave"] + a)
    return admits, bad


def held_to_stream(calls, admits: List[np.ndarray], cfg: dict,
                   overlay: ivf_live.Overlay, plant_id: np.ndarray,
                   plant_row: np.ndarray) -> Dict[str, int]:
    """``deleted_returned`` and ``acked_add_missed`` over every answer
    (the module's docstring)."""
    deleted = overlay.deleted.cpu().numpy()
    added = overlay.added.cpu().numpy()
    by_row = np.argsort(plant_row, kind="stable")
    p_row = plant_row[by_row]
    p_id = plant_id[by_row]
    p_added = added[p_id - overlay.n_base]
    p_deleted = deleted[p_id]
    out = {"deleted_returned": 0, "acked_add_missed": 0}
    for call, admit in zip(calls, admits):
        res, probes = call.report.results, call.report.probes
        have = np.array([j for j in range(call.pool_idx.shape[0])
                         if j in res and j in probes], np.int64)
        if not have.size:
            continue
        ids = np.stack([np.asarray(res[j]) for j in have]).astype(np.int64)
        p = np.array([probes[j] for j in have], np.int64)
        a = admit[have]
        last = a + np.maximum(-(-p // cfg["chunk"]), 1) - 1
        ok = (ids >= 0) & (ids < deleted.shape[0])
        gone = np.where(ok, deleted[np.clip(ids, 0, deleted.shape[0] - 1)],
                        ivf_live.NEVER)
        out["deleted_returned"] += int((gone < last[:, None]).any(1).sum())
        rows = call.pool_idx[have]
        lo = np.searchsorted(p_row, rows, "left")
        cnt = np.searchsorted(p_row, rows, "right") - lo
        ans = np.repeat(np.arange(have.size), cnt)
        pl = np.repeat(lo - np.cumsum(cnt) + cnt, cnt) + np.arange(cnt.sum())
        due = (p_added[pl] < a[ans]) & (p_deleted[pl] >= last[ans])
        held = (ids[ans] == p_id[pl][:, None]).any(1)
        out["acked_add_missed"] += np.unique(ans[due & ~held]).size
    return out
