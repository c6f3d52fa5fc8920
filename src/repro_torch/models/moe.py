"""Mixture-of-Experts FFN: sort-based capacity dispatch (port of
``repro.models.moe``).

No O(T·E·C) one-hot dispatch product: tokens are argsorted by expert,
ranked within their expert, and scattered into an (E, capacity, d)
buffer; the expert FFNs are batched products over that buffer, in bf16
as the reference's einsums (the JAX package computes them outside any
Pallas kernel).  Covers both DBRX (16 experts, top-4) and DeepSeekMoE
(2 shared + 64 routed, top-6, first layer dense).

Under a mesh (``distributed.context.activation_mesh``) ``moe_forward``
does what the reference's ``shard_map`` does: each DP rank routes its
own block of the batch, with the expert weights gathered on use from
their DP shards.  Where the reference leaves the expert split over the
``model`` axis to XLA's partitioner, each model rank here runs the FFNs
of its E/m experts and one all-gather over the model group restores the
whole (E, C, d) output buffer.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import TransformerConfig
from repro_torch.distributed import context as ctx
from repro_torch.distributed.collectives import all_gather, all_reduce
from repro_torch.launch.mesh import axis_index
from repro_torch.models.layers import dense, dense_init, mlp, mlp_init, normal

Params = Dict[str, torch.Tensor]
# the expert weights: FSDP-sharded on dim 1 over the DP axes under a mesh
EXPERT_WEIGHTS = ("wi", "wg", "wo")


def moe_init(gen: torch.Generator, cfg: TransformerConfig) -> Params:
    mo = cfg.moe
    d, ff, e = cfg.d_model, mo.d_ff_expert, mo.n_experts
    p = {
        "router": dense_init(gen, d, e, scale=0.02),
        "wi": normal(gen, (e, d, ff)) * (1.0 / np.sqrt(d)),
        "wg": normal(gen, (e, d, ff)) * (1.0 / np.sqrt(d)),
        "wo": normal(gen, (e, ff, d)) * (1.0 / np.sqrt(ff)),
    }
    if mo.n_shared:
        p["shared"] = mlp_init(gen, d, mo.n_shared * ff, "swiglu")
    return p


def _dispatch_indices(expert_idx: torch.Tensor, n_experts: int,
                      capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """expert_idx: (T*K,) -> (slot index into E*C, keep mask, perm), all
    in expert-sorted order.  A token past its expert's capacity gets slot
    E*C, one past the buffer, so that it overwrites no kept entry."""
    tk = expert_idx.shape[0]
    perm = torch.argsort(expert_idx, stable=True)
    sorted_e = expert_idx[perm]
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=expert_idx.device,
                               dtype=sorted_e.dtype), side="left")
    rank = torch.arange(tk, device=expert_idx.device) - starts[sorted_e]
    keep = rank < capacity
    slot = torch.where(keep, sorted_e * capacity + rank,
                       n_experts * capacity)
    return slot, keep, perm


def capacity_of(t: int, cfg: TransformerConfig) -> int:
    """Slots per expert for ``t`` tokens.  The floor min(t*k, 8) keeps
    tiny batches (decode) drop-free, as the reference's does."""
    mo = cfg.moe
    k = mo.top_k
    return int(max(math.ceil(t * k / mo.n_experts * mo.capacity_factor),
                   min(t * k, 8)))


def _expert_ffn(buf: torch.Tensor, p: Params) -> torch.Tensor:
    """(E', C, d) -> (E', C, d): each expert's SwiGLU FFN in bf16."""
    bh = buf.to(torch.bfloat16)
    h = F.silu(torch.bmm(bh, p["wg"].to(torch.bfloat16))) * \
        torch.bmm(bh, p["wi"].to(torch.bfloat16))
    return torch.bmm(h, p["wo"].to(torch.bfloat16))


class RouteLog:
    """What each ``_moe_core`` call routed while the log was open, in call
    order: (the router's f32 probabilities (T, E), each token's experts
    (T, K), the token-expert assignments dropped past capacity (0-d))."""

    def __init__(self):
        self.calls: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []

    def dropped(self) -> int:
        return int(sum(int(d) for _, _, d in self.calls))

    def assigned(self) -> int:
        return sum(e.numel() for _, e, _ in self.calls)


_open_logs: List[RouteLog] = []


@contextmanager
def route_log():
    """Record every MoE layer's routing until the block ends (an
    observer: the layers compute the same either way)."""
    log = RouteLog()
    _open_logs.append(log)
    try:
        yield log
    finally:
        _open_logs.remove(log)


def _moe_core(p: Params, x: torch.Tensor, cfg: TransformerConfig,
              model_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (out (B,S,d) bf16, aux f32).  With ``model_group``,
    this rank runs the FFNs of its block of the experts and the group's
    all-gather assembles the output buffer."""
    mo = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = mo.n_experts, mo.top_k
    capacity = capacity_of(t, cfg)
    xt = x.reshape(t, d)

    probs = torch.softmax(dense(p["router"], xt, dtype=torch.float32), -1)
    top_p, top_e = torch.topk(probs, k, dim=-1)                 # (T,K)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # aux load-balance loss (Switch): E * mean(frac_tokens * frac_prob)
    frac_prob = probs.mean(0)
    flat_e = top_e.reshape(-1)
    counts = torch.zeros((e,), dtype=torch.float32, device=x.device) \
        .index_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    frac_tok = counts / (t * k)
    aux = e * torch.sum(frac_prob * frac_tok) * mo.router_aux_weight

    slot, keep, perm = _dispatch_indices(flat_e, e, capacity)
    for log in _open_logs:
        log.calls.append((probs, top_e, (~keep).sum()))
    tok_of = perm // k                                          # token/slot
    gathered = xt[tok_of]                                       # (T*K, d)
    # one row past the buffer takes the dropped tokens' writes
    buf = xt.new_zeros((e * capacity + 1, d))
    buf[slot] = torch.where(keep[:, None], gathered, 0.0).to(xt.dtype)
    buf = buf[:-1].reshape(e, capacity, d)

    m = model_group.size() if model_group is not None else 1
    if m > 1 and e % m == 0:
        lo = axis_index(model_group) * (e // m)
        local = {name: p[name][lo: lo + e // m] for name in EXPERT_WEIGHTS}
        out_buf = all_gather(_expert_ffn(buf[lo: lo + e // m], local),
                             model_group).reshape(e, capacity, d)
    else:
        out_buf = _expert_ffn(buf, p)

    # the reference's mode="clip": dropped slots read the last slot, and
    # their weight is 0
    back = out_buf.reshape(e * capacity, d)[slot.clamp(max=e * capacity - 1)]
    w = top_p.reshape(-1)[perm] * keep
    contrib = back * w[:, None].to(back.dtype)
    # each token's k contributions back in their (token, k) places, then
    # summed in f32 and rounded once: the reference scatter-adds them in
    # bf16, in an order XLA leaves open; an index_add_ on the card adds
    # by atomics, in an order that changes from run to run
    out = torch.empty_like(contrib).index_copy_(0, perm, contrib) \
        .view(t, k, d).sum(1, dtype=torch.float32).to(contrib.dtype)

    if mo.n_shared:
        out = out + mlp(p["shared"], xt, "swiglu")
    return out.reshape(b, s, d), aux


def moe_forward(p: Params, x: torch.Tensor, cfg: TransformerConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out, aux_loss).

    With no mesh, or a batch that the DP size does not divide (a B=1
    decode), this is ``_moe_core``.  Under a mesh, ``x`` is this rank's
    block of the batch (split over the DP axes), ``wi``, ``wg`` and ``wo``
    this rank's block of their dim 1 (FSDP over the DP axes, in their
    flattened order) and the rest of ``p`` whole: each DP rank routes
    its own tokens, the expert weights are all-gathered in bf16 on use,
    each model rank runs its experts' FFNs, and the aux loss is the mean
    of the DP ranks' values.  Every rank must call it."""
    mesh = ctx.current_mesh()
    dp = ctx.dp_axes()
    if mesh is None or dp is None:
        return _moe_core(p, x, cfg)
    dp_group = ctx.axis_group_of(dp)
    if x.shape[0] % dp_group.size():
        return _moe_core(p, x, cfg)
    pl = dict(p)
    for name in EXPERT_WEIGHTS:
        # ZeRO-3 gather-on-use: (S, E, d/S, f) blocks -> (E, d, f)
        w = all_gather(p[name].to(torch.bfloat16), dp_group)
        pl[name] = torch.cat(list(w), dim=1)
    model = ctx.model_axis()
    out, aux = _moe_core(pl, x, cfg,
                         model_group=ctx.axis_group_of((model,))
                         if model else None)
    return out, all_reduce(aux, dp_group) / dp_group.size()
