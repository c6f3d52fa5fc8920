"""Fused multi-probe IVF scan -> top-k merge, with the delta stream.

Port of ``repro.kernels.ivf_scan_merge``.  For each query and each of
its ``chunk`` probe slots: score the probed list, mask rows at or past
the list size and ids < 0, mark the new candidates with
``sort.NEW_MARK``, merge them into the packed running top-k, count the
survivors still marked (phi = 100 * (k - count) / k), strip the marks
and snapshot the slot.

With the delta stream (the live index's buffer: ``delta_vecs``,
``delta_ids``, ``delta_assign`` and ``gate_cids``, all four or none)
at each slot the entries whose assign equals the slot's gate and whose
id is >= 0 join the slot's candidates, NEW-marked.  One merge of the
running top-k with the list rows and the gated entries keeps the same
records as the reference's two merges, because the packed order is
total.

On a CUDA tensor the wrapper launches ``csrc/ivf_scan_merge.cu`` (one
CTA walks one query's chunk, the running top-k in shared memory, the
list rows streamed into a shared ring by ``cp.async.bulk`` from a
producer warp, only the candidates above the running k-th merged, only
the gated buffer rows scored); on a CPU tensor it runs
:func:`ivf_scan_merge_plain`.  Scores keep the -1e30 sentinel on empty
slots; ``kernels/ops.py`` maps it back to -inf.
Launches with the stream count in ``ivf_scan_merge.delta_launches``,
those without it in ``ivf_scan_merge.launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, sort
from repro_torch.kernels.delta_scan import delta_scan_plain
from repro_torch.kernels.ivf_scan import score_rows

NEG = -1e30          # finite stand-in for -inf inside the sort network
VALID_MIN = -1e29    # scores above this are real candidates
KEY_NEG = sort.key_of(NEG)
KEY_VALID = sort.key_of(VALID_MIN)

# csrc/ivf_scan_merge.cu's layout: a stage holds TILE_ROWS rows and their
# ids, the gated list LIST entries
TILE_ROWS, LIST, MAX_STAGES = 16, 256, 4
STATIC_SMEM = 128    # the kernel's static shared memory, rounded up


def smem_bytes(d: int, k: int, chunk: int, list_pad: int,
               stages: int) -> int:
    """The kernel's dynamic shared memory (``smem_bytes`` in the source):
    the ring's rows and ids, the running top-k and its merge scratch, a
    survivor buffer that holds a slot's list rows and its sorted copy, q,
    the gated list and gather buffer, five ints per slot.  No term grows
    with the delta buffer's capacity."""
    surv = max(list_pad, TILE_ROWS)      # a slot's list rows
    return (stages * TILE_ROWS * (d + 1) * 4 + 2 * k * 8
            + 16 * surv + d * 4 + 3 * LIST * 4
            + 5 * chunk * 4)


def ring_stages(d: int, k: int, chunk: int, list_pad: int, aligned: bool,
                limit: int) -> int:
    """Stages of the kernel's ring: the most (up to MAX_STAGES) that fit
    ``limit`` bytes of shared memory; 0 (rows and ids read from global
    memory) when ``cp.async.bulk`` cannot copy them (d not a multiple of
    4, or not ``aligned``: docs and ids 16-byte aligned, blk_l a multiple
    of TILE_ROWS) or two stages do not fit."""
    if d % 4 or not aligned:
        return 0
    for stages in range(MAX_STAGES, 1, -1):
        if smem_bytes(d, k, chunk, list_pad, stages) + STATIC_SMEM <= limit:
            return stages
    return 0


def ivf_scan_merge_plain(queries, docs, ids2d, block_offsets, sizes,
                         run_scores, run_ids, *, k: int, list_pad: int,
                         chunk: int, blk_l: int, delta_vecs=None,
                         delta_ids=None, delta_assign=None, gate_cids=None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    b = queries.shape[0]
    ids = ids2d.reshape(-1)
    boffs = block_offsets.long().reshape(b, chunk)
    sizes = sizes.reshape(b, chunk)
    has_delta = delta_vecs is not None
    cap = delta_vecs.shape[0] if has_delta else 0
    m_pad = sort.next_pow2(k + list_pad + cap)
    lane = torch.arange(list_pad, device=queries.device)
    run = sort.pack(sort.score_to_key(torch.clamp_min(run_scores, NEG)),
                    run_ids)
    if has_delta:
        d_key = sort.score_to_key(delta_scan_plain(queries, delta_vecs))
        gates = gate_cids.reshape(b, chunk)
    out_s, out_i, cnt = [], [], []
    for j in range(chunk):
        rows = boffs[:, j:j + 1] * blk_l + lane
        new_i = ids[rows]
        alive = (lane < sizes[:, j:j + 1]) & (new_i >= 0)
        new_k = torch.where(alive, sort.score_to_key(
            score_rows(queries, docs, rows)), KEY_NEG)
        new_iw = torch.where(alive, new_i | sort.NEW_MARK, -1)
        if has_delta:
            gate = (delta_assign[None, :] == gates[:, j:j + 1]) \
                & (delta_ids[None, :] >= 0)
            new_k = torch.cat([new_k, torch.where(gate, d_key, KEY_NEG)], 1)
            new_iw = torch.cat([new_iw, torch.where(
                gate, delta_ids[None, :] | sort.NEW_MARK, -1)], 1)
        res = sort.merge_packed(run, new_k, new_iw, m_pad,
                                pad_key=KEY_NEG)[:, :, :k]
        keys, idw = res[:, 0], res[:, 1]
        kept = ((keys > KEY_VALID) & ~sort.is_marked(idw)).sum(1)
        clean = sort.strip_marks(idw)
        out_s.append(sort.key_to_score(keys))
        out_i.append(clean)
        cnt.append((k - kept).to(torch.int32))
        run = sort.pack(keys, clean)
    return (torch.stack(out_s, 1), torch.stack(out_i, 1),
            torch.stack(cnt, 1))


def ivf_scan_merge(queries: torch.Tensor, docs: torch.Tensor,
                   ids2d: torch.Tensor, block_offsets: torch.Tensor,
                   sizes: torch.Tensor, run_scores: torch.Tensor,
                   run_ids: torch.Tensor, *, k: int, list_pad: int,
                   chunk: int, blk_l: int = 64,
                   delta_vecs: Optional[torch.Tensor] = None,
                   delta_ids: Optional[torch.Tensor] = None,
                   delta_assign: Optional[torch.Tensor] = None,
                   gate_cids: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """queries (B, d); docs (n, d) cluster-major; ids2d (n // blk_l,
    blk_l) doc ids, -1 on padding; block_offsets / sizes (B * chunk,)
    int32 (offsets in blk_l units); run_scores / run_ids (B, k) the
    incoming top-k.  Delta stream: delta_vecs (cap, d) f32, delta_ids /
    delta_assign (cap,) int32 (id -1 on empty or tombstoned slots),
    gate_cids (B * chunk,) int32, each slot's probed cluster or -2 past
    the probe budget.  Returns (B, chunk, k) snapshot scores (NEG on
    empty slots) and ids, and (B, chunk) int32 new-entry counts."""
    if blk_l <= 0 or list_pad % blk_l:
        raise ValueError(f"list_pad={list_pad} must be a positive "
                         f"multiple of blk_l={blk_l}")
    delta = (delta_vecs, delta_ids, delta_assign, gate_cids)
    has_delta = delta_vecs is not None
    if any((x is not None) != has_delta for x in delta):
        raise ValueError("ivf_scan_merge: delta_vecs, delta_ids, "
                         "delta_assign and gate_cids come together or "
                         "not at all")
    b, d = queries.shape
    cap = delta_vecs.shape[0] if has_delta else 0
    specs = dict(
        queries=(queries, torch.float32, (b, d)),
        docs=(docs, torch.float32, (None, d)),
        ids2d=(ids2d, torch.int32, (None, blk_l)),
        block_offsets=(block_offsets, torch.int32, (b * chunk,)),
        sizes=(sizes, torch.int32, (b * chunk,)),
        run_scores=(run_scores, torch.float32, (b, k)),
        run_ids=(run_ids, torch.int32, (b, k)))
    if has_delta:
        specs.update(
            delta_vecs=(delta_vecs, torch.float32, (cap, d)),
            delta_ids=(delta_ids, torch.int32, (cap,)),
            delta_assign=(delta_assign, torch.int32, (cap,)),
            gate_cids=(gate_cids, torch.int32, (b * chunk,)))
    dev = _build.check_inputs("ivf_scan_merge", **specs)
    if dev.type == "cpu":
        return ivf_scan_merge_plain(
            queries, docs, ids2d, block_offsets, sizes, run_scores, run_ids,
            k=k, list_pad=list_pad, chunk=chunk, blk_l=blk_l,
            delta_vecs=delta_vecs, delta_ids=delta_ids,
            delta_assign=delta_assign, gate_cids=gate_cids)
    if not 0 < k <= 1024:
        raise ValueError(f"ivf_scan_merge: k={k} outside (0, 1024]")
    aligned = (docs.data_ptr() % 16 == 0 and ids2d.data_ptr() % 16 == 0
               and blk_l % TILE_ROWS == 0)
    stages = ring_stages(d, k, chunk, list_pad, aligned,
                         _build.max_shared_optin(dev))
    _build.check_smem("ivf_scan_merge", dev,
                      smem_bytes(d, k, chunk, list_pad, stages) + STATIC_SMEM,
                      f"k={k}, d={d}, chunk={chunk}, list_pad={list_pad}")
    out_s = torch.empty((b, chunk, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, chunk, k), dtype=torch.int32, device=dev)
    cnt = torch.empty((b, chunk), dtype=torch.int32, device=dev)
    if b and chunk:
        dptr = [x.data_ptr() if has_delta else None for x in delta]
        _build.launch(
            "ivf_scan_merge", dev, queries.data_ptr(), docs.data_ptr(),
            ids2d.data_ptr(), block_offsets.data_ptr(), sizes.data_ptr(),
            run_scores.data_ptr(), run_ids.data_ptr(), *dptr,
            out_s.data_ptr(), out_i.data_ptr(), cnt.data_ptr(), b, d, k,
            chunk, list_pad, blk_l, cap, stages)
        if has_delta:
            ivf_scan_merge.delta_launches += 1
        else:
            ivf_scan_merge.launches += 1
    return out_s, out_i, cnt


ivf_scan_merge.launches = 0
ivf_scan_merge.delta_launches = 0
