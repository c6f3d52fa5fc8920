"""Layered (fanout) neighbor sampling for minibatch GNN training: a copy
of ``repro.data.graph_sampler`` (NumPy only, on the host), so one ``rng``
gives the same blocks in both packages, bit for bit.

GraphSAGE-style blocks with the DGL convention: each block's *output*
(dst) nodes are a prefix of its *input* (src) node array, so layer i's
activations are rows [0, n_out) of the aggregation over block i. Blocks
are padded to static shapes, so every step of a training loop sees the
same tensor shapes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray    # (N+1,)
    indices: np.ndarray   # (E,) in-neighbor (src) per incoming edge
    n_nodes: int

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray,
                   n_nodes: int) -> "CSRGraph":
        order = np.argsort(dst, kind="stable")
        s, d = src[order], dst[order]
        counts = np.bincount(d, minlength=n_nodes)
        indptr = np.zeros(n_nodes + 1, np.int64)
        indptr[1:] = np.cumsum(counts)
        return cls(indptr, s.astype(np.int32), n_nodes)


@dataclass
class Block:
    """Bipartite sampled layer. src/dst index into ``nodes``; dst nodes
    are nodes[:n_out]."""
    edge_src: np.ndarray   # (E_pad,) int32 positions into nodes
    edge_dst: np.ndarray   # (E_pad,) int32 positions into nodes[:n_out]
    edge_mask: np.ndarray  # (E_pad,) bool
    nodes: np.ndarray      # (N_pad,) int32 global node ids (dst prefix)
    n_out: int


def sample_blocks(g: CSRGraph, seeds: np.ndarray, fanouts: Sequence[int],
                  rng: np.random.Generator) -> List[Block]:
    """Returns blocks outermost-first (blocks[0] feeds the final layer).
    blocks[-1].nodes is the full input node set (layer-0 features)."""
    blocks: List[Block] = []
    cur = np.asarray(seeds, np.int32)
    for f in fanouts:
        n_dst = cur.shape[0]
        e_pad = n_dst * f
        src_g = np.zeros(e_pad, np.int32)   # global src ids
        dst_p = np.zeros(e_pad, np.int32)   # dst position (into cur)
        mask = np.zeros(e_pad, bool)
        for i, v in enumerate(cur):
            lo, hi = g.indptr[v], g.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, deg)
            picks = g.indices[lo + rng.choice(deg, take,
                                              replace=bool(deg < take))]
            src_g[i * f: i * f + take] = picks
            dst_p[i * f: i * f + take] = i
            mask[i * f: i * f + take] = True
        extra = np.setdiff1d(src_g[mask], cur)
        nodes = np.concatenate([cur, extra]).astype(np.int32)
        # map global src ids -> positions in nodes
        order = np.argsort(nodes, kind="stable")
        pos_sorted = np.searchsorted(nodes[order], src_g)
        src_p = order[np.clip(pos_sorted, 0, nodes.size - 1)].astype(
            np.int32)
        src_p[~mask] = 0
        blocks.append(Block(src_p, dst_p, mask, nodes, n_dst))
        cur = nodes
    return blocks


def pad_block(b: Block, e_pad: int, n_pad: int) -> Block:
    def pade(a, fill=0):
        out = np.full(e_pad, fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    nodes = np.zeros(n_pad, np.int32)
    nodes[: b.nodes.shape[0]] = b.nodes
    return Block(pade(b.edge_src), pade(b.edge_dst),
                 pade(b.edge_mask, False), nodes, b.n_out)


def block_shapes(batch_nodes: int, fanouts: Sequence[int]
                 ) -> List[Tuple[int, int, int]]:
    """Static (e_pad, n_pad, n_out) per block, outermost-first."""
    out = []
    n_dst = batch_nodes
    for f in fanouts:
        e_pad = n_dst * f
        n_pad = n_dst + e_pad           # worst case: all srcs distinct
        out.append((e_pad, n_pad, n_dst))
        n_dst = n_pad
    return out
