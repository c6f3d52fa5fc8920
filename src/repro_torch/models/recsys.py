"""RecSys models: DeepFM / DCN-v2 / xDeepFM / two-tower retrieval,
training and serving (port of ``repro.models.recsys``).

All sparse fields share one combined table (a row offset per field).
DeepFM's FM term sums each example's embedding rows twice (the (B, D)
``sv`` and the linear term), which is exactly an EmbeddingBag: both go
through ``kernels.ops.embedding_bag`` (the CUDA kernel on the card, its
plain ordered sum on the CPU), the kernel the reference names for this
hot path.  The (B, F, D) gather that feeds the MLP and the square term
stays a plain lookup (``layers.gather_rows``), as the reference's
``jnp.take``.  Both run under autograd with deterministic table
gradients (a sort and a segment sum, no atomics); inside
:func:`plain_bags` the bag sums run through ``embedding_bag_plain``
under the same backward, the path the kernel's is held against.

The MLPs run in f32 (the reference passes ``dtype=jnp.float32``), with
TF32 off on the card.  ``init_params`` and ``params_from_numpy`` run on
the card unless given ``device="cpu"``; ``loss_fn``, ``serve_logits``
and ``score_candidates`` run where their inputs lie.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import ops
from repro_torch.models.layers import (dense, dense_init, from_numpy,
                                       gather_rows, normal, tree_map)

Params = Dict[str, object]


def table_rows(cfg: RecsysConfig) -> int:
    return cfg.n_sparse * cfg.rows_per_field


def field_offsets(cfg: RecsysConfig, device=None) -> torch.Tensor:
    return torch.arange(cfg.n_sparse, dtype=torch.int32,
                        device=device) * cfg.rows_per_field


def _combined_ids(ids: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """Field-local (B, F) ids -> rows of the combined table."""
    return ids + field_offsets(cfg, ids.device)[None, :]


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     cfg: RecsysConfig) -> torch.Tensor:
    """ids (B, F) field-local -> (B, F, D) via one combined-table gather."""
    return gather_rows(table, _combined_ids(ids, cfg))


def _mlp_init(gen: torch.Generator, dims: Tuple[int, ...]) -> Params:
    return {f"l{i}": dense_init(gen, dims[i], dims[i + 1], bias=True)
            for i in range(len(dims) - 1)}


def _mlp_apply(p: Params, x: torch.Tensor, *,
               final_act: bool = False) -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = dense(p[f"l{i}"], x, dtype=torch.float32)
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# init / weights from the reference
# ---------------------------------------------------------------------------


def init_params(cfg: RecsysConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random weights at ``cfg``'s shapes, drawn from a ``torch.Generator``
    seeded with ``seed`` on the device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = table_rows(cfg)
    p: Params = {"table": normal(gen, (rows, cfg.embed_dim)) * 0.01}
    d_in = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    if cfg.interaction == "fm":
        p["linear_table"] = normal(gen, (rows, 1)) * 0.01
        p["mlp"] = _mlp_init(gen, (d_in,) + cfg.mlp + (1,))
    elif cfg.interaction == "cross":
        for i in range(cfg.n_cross_layers):
            p[f"cross_w{i}"] = dense_init(gen, d_in, d_in, bias=True)
        p["mlp"] = _mlp_init(gen, (d_in,) + cfg.mlp + (1,))
    elif cfg.interaction == "cin":
        f0 = prev = cfg.n_sparse
        for i, hk in enumerate(cfg.cin_layers):
            p[f"cin_w{i}"] = normal(gen, (hk, prev, f0)) \
                * (1.0 / np.sqrt(prev * f0))
            prev = hk
        p["cin_out"] = dense_init(gen, sum(cfg.cin_layers), 1, bias=True)
        p["mlp"] = _mlp_init(gen, (d_in,) + cfg.mlp + (1,))
    elif cfg.interaction == "dot":     # two-tower
        d_feat = (cfg.n_sparse // 2) * cfg.embed_dim
        p["user_mlp"] = _mlp_init(gen, (d_feat,) + cfg.tower_mlp)
        p["item_mlp"] = _mlp_init(gen, (d_feat,) + cfg.tower_mlp)
    else:
        raise ValueError(cfg.interaction)
    return p


def params_from_numpy(cfg: RecsysConfig, tree: Params,
                      device: DeviceLike = None) -> Params:
    """The reference's parameter tree (numpy arrays) as the port's params
    on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: from_numpy(a, dev), tree)


# ---------------------------------------------------------------------------
# forward per interaction type
# ---------------------------------------------------------------------------

_plain: List[bool] = []


@contextmanager
def plain_bags():
    """While open, DeepFM's bag sums run through ``embedding_bag_plain``
    (the kernel's plain version) with the kernel path's backward."""
    _plain.append(True)
    try:
        yield
    finally:
        _plain.pop()


def _bag(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    if table.device.type == "meta":
        # the dry run's storage-less programs: the gathered rows' sum,
        # the bag's shapes (its kernel and plain version index by value)
        return gather_rows(table, rows).float().sum(1)
    if _plain:
        return _eb.EmbeddingBagPlainFunction.apply(
            table.contiguous(), rows.to(torch.int32).contiguous())
    return ops.embedding_bag(table, rows)



def _batch(params: Params, batch: Dict) -> Dict[str, torch.Tensor]:
    """The features serving reads, on the params' device (labels stay)."""
    dev = params["table"].device
    return {k: torch.as_tensor(batch[k], device=dev)
            for k in ("sparse", "dense") if k in batch}


def forward(cfg: RecsysConfig, params: Params,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """CTR models -> (B,) logit. Two-tower handled separately."""
    batch = _batch(params, batch)
    ids = batch["sparse"]
    emb = embedding_lookup(params["table"], ids, cfg)      # (B,F,D)
    b = emb.shape[0]
    flat = emb.reshape(b, -1)
    x0 = torch.cat([batch["dense"], flat], 1) if cfg.n_dense else flat

    if cfg.interaction == "fm":
        rows = _combined_ids(ids, cfg)
        lin = _bag(params["linear_table"], rows)[:, 0]
        sv = _bag(params["table"], rows)                     # (B, D)
        fm = 0.5 * (sv * sv - (emb * emb).sum(1)).sum(1)
        deep = _mlp_apply(params["mlp"], x0)[:, 0]
        return lin + fm + deep
    if cfg.interaction == "cross":
        x = x0
        for i in range(cfg.n_cross_layers):
            xw = dense(params[f"cross_w{i}"], x, dtype=torch.float32)
            x = x0 * xw + x
        return _mlp_apply(params["mlp"], x)[:, 0]
    if cfg.interaction == "cin":
        xk = emb                                          # (B, Hk, D)
        outs = []
        for i in range(len(cfg.cin_layers)):
            z = torch.einsum("bhd,bfd->bhfd", xk, emb)
            xk = torch.einsum("bhfd,ohf->bod", z, params[f"cin_w{i}"])
            outs.append(xk.sum(-1))                       # (B, Hk)
        cin = dense(params["cin_out"], torch.cat(outs, 1),
                    dtype=torch.float32)[:, 0]
        deep = _mlp_apply(params["mlp"], x0)[:, 0]
        return cin + deep
    raise ValueError(cfg.interaction)


def dataclass_like(cfg: RecsysConfig) -> RecsysConfig:
    """cfg clone whose embed dim matches the 1-wide linear table."""
    return dataclasses.replace(cfg, embed_dim=1)


def loss_fn(cfg: RecsysConfig, params: Params,
            batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """The CTR models' mean logistic loss on ``batch["label"]`` (B,),
    with the logits' mean; two-tower's in-batch softmax."""
    if cfg.interaction == "dot":
        return two_tower_loss(cfg, params, batch)
    logit = forward(cfg, params, batch)
    y = torch.as_tensor(batch["label"], device=logit.device)
    loss = (torch.clamp_min(logit, 0) - logit * y
            + torch.log1p(torch.exp(-logit.abs()))).mean()
    return loss, {"logit_mean": logit.mean()}


# ---------------------------------------------------------------------------
# two-tower retrieval
# ---------------------------------------------------------------------------


def tower_embeddings(cfg: RecsysConfig, params: Params,
                     batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    batch = _batch(params, batch)
    half = cfg.n_sparse // 2
    emb = embedding_lookup(params["table"], batch["sparse"], cfg)
    b = emb.shape[0]
    u = _mlp_apply(params["user_mlp"], emb[:, :half].reshape(b, -1))
    v = _mlp_apply(params["item_mlp"], emb[:, half:].reshape(b, -1))
    u = u / torch.clamp(torch.linalg.norm(u, dim=1, keepdim=True), min=1e-6)
    v = v / torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True), min=1e-6)
    return u, v


def two_tower_loss(cfg: RecsysConfig, params: Params,
                   batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """In-batch sampled softmax (RecSys'19) at temperature 0.05, and the
    in-batch top-1 accuracy."""
    u, v = tower_embeddings(cfg, params, batch)
    logits = (u @ v.T) / 0.05                        # (B, B)
    labels = torch.arange(u.shape[0], device=u.device)
    lse = torch.logsumexp(logits, dim=1)
    loss = (lse - torch.diagonal(logits)).mean()
    acc = (logits.argmax(1) == labels).float().mean()
    return loss, {"acc": acc}


def score_candidates(user_emb: torch.Tensor, cand_emb: torch.Tensor,
                     k: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """The retrieval_cand brute-force path: (Q, D) x (C, D) -> the top-k
    scores and int32 candidate ids, best first (``lax.top_k``'s order
    where no two scores tie)."""
    s, i = torch.topk(user_emb @ cand_emb.T, k, dim=-1)
    return s, i.to(torch.int32)


def serve_logits(cfg: RecsysConfig, params: Params,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Pointwise online/offline scoring (serve_p99 / serve_bulk)."""
    if cfg.interaction == "dot":
        u, v = tower_embeddings(cfg, params, batch)
        return (u * v).sum(1)
    return forward(cfg, params, batch)
