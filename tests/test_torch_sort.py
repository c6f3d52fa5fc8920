"""Port parity: ``repro_torch.kernels.sort`` equals ``repro.kernels.sort``
bit for bit (key map, marks, packed network, merge)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import sort as jsort
from repro_torch.kernels import sort as tsort
from test_torch_kernels import (ROW_TOPK_KINDS, ROW_TOPK_SHAPES, TOPK_CASES,
                                row_topk_case, topk_case)

_EDGE = np.float32([0.0, -0.0, 1e-44, -1e-44, 1e-40, -1e-40, np.inf,
                    -np.inf, -1e30, -1e29, 1e30, -3.5, 3.5])


def _values(seed):
    rng = np.random.default_rng(seed)
    wide = (rng.normal(size=2000)
            * 10.0 ** rng.integers(-30, 30, 2000)).astype(np.float32)
    return np.concatenate([wide, _EDGE])


def test_key_map_matches_reference_bit_for_bit():
    vals = _values(0)
    want = np.asarray(jsort.score_to_key(jnp.asarray(vals)))
    got = tsort.score_to_key(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)
    back = tsort.key_to_score(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(back.view(np.int32), vals.view(np.int32))


@pytest.mark.parametrize("x", [-1e30, -1e29, 0.25, -0.25, float("-inf"),
                               1e30, 0.0, -0.0])
def test_key_of_matches_reference(x):
    assert tsort.key_of(x) == jsort.key_of(x)


def test_mark_helpers_match_reference():
    ids = np.asarray([[5, -1, 0, (1 << 29), 7 | jsort.NEW_MARK, -1]],
                     np.int32)
    for name in ("mark_new", "strip_marks", "is_marked"):
        want = np.asarray(getattr(jsort, name)(jnp.asarray(ids)))
        got = getattr(tsort, name)(torch.from_numpy(ids)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tsort.NEW_MARK == jsort.NEW_MARK


@pytest.mark.parametrize("m", [2, 8, 128, 512])
def test_packed_network_matches_reference(m):
    rng = np.random.default_rng(m)
    # few distinct scores, so exact ties (broken by id word) are common;
    # marked ids and -1 sentinels ride along
    sc = rng.integers(-3, 3, size=(4, m)).astype(np.float32)
    sc[:, ::7] = -1e30
    ids = rng.integers(-1, 1 << 20, size=(4, m)).astype(np.int32)
    ids[:, ::5] |= jsort.NEW_MARK
    ids[:, ::11] = -1
    keys = np.array(jsort.score_to_key(jnp.asarray(sc)))
    want = np.asarray(jsort.bitonic_desc_packed(
        jsort.pack(jnp.asarray(keys), jnp.asarray(ids))))
    got = tsort.bitonic_desc_packed(
        tsort.pack(torch.from_numpy(keys), torch.from_numpy(ids))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,m", [(10, 256), (100, 256), (3, 2)])
def test_merge_packed_matches_reference(k, m):
    rng = np.random.default_rng(k + m)
    run_k = np.array(jsort.score_to_key(jnp.asarray(
        -np.sort(-rng.normal(size=(3, k)).astype(np.float32), 1))))
    run_i = rng.integers(0, 1000, (3, k)).astype(np.int32)
    new_k = np.array(jsort.score_to_key(jnp.asarray(
        rng.normal(size=(3, m)).astype(np.float32))))
    new_i = rng.integers(0, 1000, (3, m)).astype(np.int32) | jsort.NEW_MARK
    m_pad = tsort.next_pow2(k + m)
    pad_key = jsort.key_of(-1e30)
    want = np.asarray(jsort.merge_packed(
        jsort.pack(jnp.asarray(run_k), jnp.asarray(run_i)),
        jnp.asarray(new_k), jnp.asarray(new_i), m_pad, pad_key=pad_key))
    got = tsort.merge_packed(
        tsort.pack(torch.from_numpy(run_k), torch.from_numpy(run_i)),
        torch.from_numpy(new_k), torch.from_numpy(new_i), m_pad,
        pad_key=pad_key).numpy()
    np.testing.assert_array_equal(got, want)


def _words(keys, idw):
    """(key, id word) -> one int64 word each, ordered as the records."""
    return (keys.astype(np.int64) << 32) | (idw.astype(np.int64) + (1 << 31))


def _rank_merge(a, b, k):
    """The kernel's merge of sorted ``a`` with unsorted ``b``: b sorted
    into a copy (equal records in any order: they are identical), a[i]
    placed at i + #{copy above it} and the copy's r-th at r + #{a at or
    above it}; the ranks below k."""
    srt = np.empty(len(b), np.int64)
    for j, x in enumerate(b):
        srt[int((b > x).sum() + (b[:j] == x).sum())] = x
    out = np.empty(k, np.int64)
    for i, x in enumerate(a):
        pos = i + int((srt > x).sum())
        if pos < k:
            out[pos] = x
    for r, x in enumerate(srt):
        pos = r + int((a >= x).sum())
        if pos < k:
            out[pos] = x
    return out


def _kernel_slot(run, cands, k, cand_cap, tile):
    """One probe slot of the fused kernel, as a model on int64 words:
    ``run`` in packed order, candidates fed ``tile`` at a time, those
    above the running k-th kept in a ``cand_cap`` buffer that is merged
    by rank when another tile could overflow it and at the slot's end;
    then the marks stripped, the lanes kept counted, and the running
    top-k re-ranked within equal-key groups where stripping broke the
    packed order.  Returns the snapshot's keys and ids, its count and the
    next slot's running top-k."""
    buf = []
    for t0 in range(0, len(cands), tile):
        if len(buf) + tile > cand_cap:
            run, buf = _rank_merge(run, np.asarray(buf, np.int64), k), []
        buf += [c for c in cands[t0:t0 + tile] if c > run[k - 1]]
    if buf:
        run = _rank_merge(run, np.asarray(buf, np.int64), k)
    keys = (run >> 32).astype(np.int32)
    idw = ((run & 0xFFFFFFFF) - (1 << 31)).astype(np.int32)
    kept = int(((keys > tsort.key_of(-1e29))
                & ~((idw >= 0) & ((idw & tsort.NEW_MARK) != 0))).sum())
    clean = np.where(idw >= 0, idw & ~tsort.NEW_MARK, idw)
    stripped = _words(keys, clean)
    nxt = stripped
    if ((keys[:-1] == keys[1:]) & (clean[1:] > clean[:-1])).any():
        nxt = np.empty(k, np.int64)
        for t, x in enumerate(stripped):
            group = np.flatnonzero(keys == keys[t])    # contiguous
            o = stripped[group]
            nxt[group[0] + int((o > x).sum() + (o[group < t] == x).sum())] = x
    return keys, clean, k - kept, nxt


def _kernel_rank(run, k):
    """The kernel's first step: the incoming running top-k ranked."""
    return _rank_merge(np.zeros(0, np.int64), run, k)


@pytest.mark.parametrize("k,n,cand_cap,tile", [
    (10, 300, 16, 4), (100, 256, 512, 16), (1, 50, 8, 4), (64, 4096, 32, 16)])
def test_filtered_merge_matches_merge_packed(k, n, cand_cap, tile):
    """The fused kernel's claim, on integer scores with many ties, marked
    candidates, duplicate records and empty running slots, over three
    chained slots: filtering by the running k-th, batched merges by rank,
    marks stripped at the slot's end and the re-rank after it give
    merge_packed's records and new-entry count at every slot."""
    rng = np.random.default_rng(k + n)
    pad_key = tsort.key_of(-1e30)
    for trial in range(4):
        run_k = tsort.score_to_key(torch.from_numpy(
            rng.integers(-3, 4, k).astype(np.float32))).numpy()
        run_i = rng.integers(0, 40, k).astype(np.int32)
        n_empty = rng.integers(0, k + 1) if trial else k
        run_k[k - n_empty:], run_i[k - n_empty:] = pad_key, -1
        # the running slots arrive out of order among equal records
        perm = rng.permutation(k)
        run_k, run_i = run_k[perm], run_i[perm]
        model = _kernel_rank(_words(run_k, run_i), k)
        for _ in range(3):
            new_k = tsort.score_to_key(torch.from_numpy(
                rng.integers(-3, 4, n).astype(np.float32))).numpy()
            new_i = rng.integers(0, 40, n).astype(np.int32)
            new_i[rng.random(n) < 0.1] = -1             # not candidates
            new_k[new_i < 0] = pad_key
            new_iw = np.where(new_i >= 0, new_i | tsort.NEW_MARK, -1)
            want = tsort.merge_packed(
                tsort.pack(torch.from_numpy(run_k[None]),
                           torch.from_numpy(run_i[None])),
                torch.from_numpy(new_k[None]), torch.from_numpy(new_iw[None]),
                tsort.next_pow2(k + n), pad_key=pad_key)[0, :, :k].numpy()
            w_keys, w_idw = want
            w_marked = tsort.is_marked(torch.from_numpy(w_idw)).numpy()
            w_cnt = k - int(((w_keys > tsort.key_of(-1e29)) & ~w_marked
                             ).sum())
            run_k = w_keys
            run_i = tsort.strip_marks(torch.from_numpy(w_idw)).numpy()
            keys, clean, cnt, model = _kernel_slot(
                model, _words(new_k, new_iw)[new_i >= 0], k, cand_cap, tile)
            np.testing.assert_array_equal(keys, w_keys)
            np.testing.assert_array_equal(clean, run_i)
            assert cnt == w_cnt


# -- csrc/topk_merge.cu's algorithm, modelled on the CPU ----------------------

_FREE = np.iinfo(np.int64).min       # the kernel's free slot: below every record
_PAD = int(_words(np.int32(tsort.key_of(-1e30)), np.int32(-1)))


def _records(scores, ids):
    """The kernel's packed words: non-finite scores clamped to -1e30."""
    s = np.where(np.isfinite(scores), scores, np.float32(-1e30))
    keys = tsort.score_to_key(torch.from_numpy(s.astype(np.float32))).numpy()
    return _words(keys, ids.astype(np.int32))


def _topk_merge_model(s, i, ns, ni, k, *, tile=256, buf=512,
                      key_only=False, k_pads=False):
    """One row of the topk_merge kernel on int64 words: the first
    min(k0, k) running records, ranked only if out of packed order;
    min(k, m_pad - k0 - L) pad records placed by count; the remaining
    running records and the new ones streamed ``tile`` at a time, those
    strictly above the running k-th kept in a ``buf`` buffer that is
    merged by rank when another tile could overflow it and at the end;
    sentinel-range scores written as -inf.  ``key_only`` and ``k_pads``
    are the two faults the tests below must catch: a filter on keys alone,
    and k pads whatever the reference pads with."""
    k0, n_new = len(s), len(ns)
    m_pad = tsort.next_pow2(k0 + n_new)
    kr = min(k0, k)
    run = np.full(k, _FREE, np.int64)
    run[:kr] = _records(s[:kr], i[:kr])
    if (run[:kr][:-1] < run[:kr][1:]).any():
        run[:kr] = _kernel_rank(run[:kr], kr)
    n_pad = k if k_pads else min(k, m_pad - k0 - n_new)
    at = int((run[:kr] >= _PAD).sum())
    run = np.concatenate([run[:at], np.full(n_pad, _PAD, np.int64),
                          run[at:]])[:k]
    stream = np.concatenate([_records(s[kr:], i[kr:]), _records(ns, ni)])
    kept = []
    for t0 in range(0, len(stream), tile):
        if len(kept) + tile > buf:
            run, kept = _rank_merge(run, np.asarray(kept, np.int64), k), []
        x = stream[t0:t0 + tile]
        keep = (x >> 32) > (run[k - 1] >> 32) if key_only else x > run[k - 1]
        kept += list(x[keep])
    if kept:
        run = _rank_merge(run, np.asarray(kept, np.int64), k)
    keys = (run >> 32).astype(np.int32)
    idw = ((run & 0xFFFFFFFF) - (1 << 31)).astype(np.int32)
    out = tsort.key_to_score(torch.from_numpy(keys)).numpy()
    return np.where(out > np.float32(-1e29), out, -np.inf), idw


@pytest.mark.parametrize("name", TOPK_CASES)
def test_topk_merge_kernel_model_matches_plain_and_reference(name):
    """csrc/topk_merge.cu's filtered rank merge gives the packed network's
    bits: against topk_merge_plain and the Pallas kernel (interpret
    mode)."""
    from repro.kernels import topk_merge as jtm
    from repro_torch.kernels import topk_merge as ttm

    s, i, ns, ni, k = topk_case(name)
    ps, pi = ttm.topk_merge_plain(*map(torch.from_numpy, (s, i, ns, ni)), k)
    js, ji = jtm.topk_merge(*map(jnp.asarray, (s, i, ns, ni)), k,
                            interpret=True)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    for r in range(len(s)):
        ms, mi = _topk_merge_model(s[r], i[r], ns[r], ni[r], k)
        np.testing.assert_array_equal(ms, ps[r].numpy())
        np.testing.assert_array_equal(mi, pi[r].numpy())


@pytest.mark.parametrize("fault,name", [("key_only", "all_equal"),
                                        ("key_only", "k0_above_k"),
                                        ("k_pads", "ids_below_minus_one")])
def test_topk_merge_kernel_model_catches_faults(fault, name):
    """The cases above would catch a filter on keys alone and k pad
    records in place of min(k, m_pad - k0 - L)."""
    from repro_torch.kernels import topk_merge as ttm

    s, i, ns, ni, k = topk_case(name)
    _, pi = ttm.topk_merge_plain(*map(torch.from_numpy, (s, i, ns, ni)), k)
    assert any(not np.array_equal(
        _topk_merge_model(s[r], i[r], ns[r], ni[r], k, **{fault: True})[1],
        pi[r].numpy()) for r in range(len(s)))


# -- csrc/row_topk.cu's algorithm, modelled on the CPU ------------------------


def _row_records(x, *, fold_zero=True, low_first=True):
    """The kernel's words: NaN on the top key, -0.0 on +0.0's, the
    position word ~pos (a lower position is a larger word).  The two
    flags off are faults the tests below must catch."""
    x = np.where(x == 0, np.float32(0), x) if fold_zero else x
    keys = tsort.score_to_key(torch.from_numpy(
        np.ascontiguousarray(x, np.float32))).numpy()
    keys = np.where(np.isnan(x), np.int32(np.iinfo(np.int32).max), keys)
    pos = np.arange(len(x), dtype=np.int32)
    return _words(keys, ~pos if low_first else pos)


def _row_topk_model(x, k, *, threads=256, per=8, vec=4, buf=512,
                    **faults):
    """One row of the row_topk kernel on int64 words: passes of
    ``threads * per`` columns, thread t holding columns 4t..4t+3 of each
    1,024 of a pass; a pass's survivors (above the running k-th) all
    written to a ``buf`` buffer if they fit, else the buffer merged first
    and the pass filtered again, and if they still do not fit the pass
    compacted ``threads`` columns at a time, merging when the next could
    overflow or, until k records are held, when k are buffered; a merge
    at the end.  The records are unique, so any exact merge is the
    kernel's.  Values are read back at the kept positions."""
    w = len(x)
    words = _row_records(x, **faults)
    run = np.full(k, _FREE, np.int64)
    kept = np.zeros(0, np.int64)
    held = 0

    def merge(run, kept):
        return np.sort(np.concatenate([run, kept]))[::-1][:k]

    for c0 in range(0, w, threads * per):
        cols = np.arange(c0, min(c0 + threads * per, w))
        for merged in (False, True):
            surv = words[cols][words[cols] > run[k - 1]]
            if len(kept) + len(surv) <= buf:
                kept = np.concatenate([kept, surv])
                break
            if len(kept) == 0 or merged:
                # column i of every thread: i // vec selects the 1,024,
                # i % vec the column within a thread's 4
                for i in range(per):
                    sub = cols[((cols - c0) // (threads * vec) == i // vec)
                               & ((cols - c0) % vec == i % vec)]
                    if len(kept) + threads > buf \
                            or (held < k and len(kept) >= k):
                        held += len(kept)
                        run, kept = merge(run, kept), kept[:0]
                    kept = np.concatenate(
                        [kept, words[sub][words[sub] > run[k - 1]]])
                break
            held += len(kept)
            run, kept = merge(run, kept), kept[:0]
    if len(kept):
        run = merge(run, kept)
    idw = ((run & 0xFFFFFFFF) - (1 << 31)).astype(np.int32)
    pos = ~idw if faults.get("low_first", True) else idw
    return x[pos], pos


@pytest.mark.parametrize("w,k", ROW_TOPK_SHAPES)
@pytest.mark.parametrize("kind", ROW_TOPK_KINDS)
def test_row_topk_kernel_model_is_the_stable_sort(kind, w, k):
    """csrc/row_topk.cu's records, filter and merges give the stable
    sort's first k bit for bit (values and positions), NaN, +-0.0 and
    ties to the lower position included."""
    from repro_torch.kernels import row_topk as t_rt

    x = row_topk_case(kind, w)
    ws, wi = t_rt.row_topk_plain(torch.from_numpy(x), k)
    for r in range(len(x)):
        ms, mi = _row_topk_model(x[r], k)
        np.testing.assert_array_equal(mi, wi[r].numpy())
        np.testing.assert_array_equal(ms.view(np.int32),
                                      ws[r].numpy().view(np.int32))


@pytest.mark.parametrize("fault,kind", [("fold_zero", "specials"),
                                        ("low_first", "ties"),
                                        ("low_first", "specials")])
def test_row_topk_kernel_model_catches_faults(fault, kind):
    """The cases above would catch -0.0 keyed below +0.0 and ties given
    to the higher position."""
    from repro_torch.kernels import row_topk as t_rt

    x = row_topk_case(kind, 356)
    _, wi = t_rt.row_topk_plain(torch.from_numpy(x), 100)
    assert any(not np.array_equal(_row_topk_model(x[r], 100,
                                                  **{fault: False})[1],
                                  wi[r].numpy()) for r in range(len(x)))
