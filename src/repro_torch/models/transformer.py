"""Decoder-only LM serving: dense GQA layers (port of the dense path of
``repro.models.transformer``).

Entry points:
  init_params(cfg, seed, device=None)        -> params (f32 weights)
  params_from_numpy(cfg, tree, device=None)  -> params from a reference tree
  forward(cfg, params, tokens)               -> (logits f32 (B,S,V), aux)
  prefill(cfg, params, tokens, max_seq)      -> (last logits (B,V), LMCache)
  decode_step(cfg, params, cache, token, pos) -> (logits (B,V), cache)

Params are a dict: ``embed`` (V, d), ``ln_f``, optional ``out`` and
``layers``, a list of per-layer dicts (the reference stacks them along
a leading L axis for ``lax.scan``; here the layer loop is a Python
loop).  Weights stay f32 and every ``dense`` casts them to bf16 on use,
as the reference does.  ``prefill`` and ``decode_step`` run where the
params lie; ``init_params`` and ``params_from_numpy`` run on the card
unless given ``device="cpu"``.  ``decode_step`` writes the cache in
place.  MLA, MoE, the int8 KV cache and training (``loss_fn``) are not
ported yet (``ROADMAP.md``, Queue 1 item 6).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import TransformerConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense, dense_init, from_numpy, mlp,
                                       mlp_init, normal, rmsnorm,
                                       rmsnorm_init, tree_map)

Params = Dict[str, Any]


def _check(cfg: TransformerConfig, *, cache: bool = False) -> None:
    if cfg.attn_type != "gqa" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA and MoE models are not ported yet "
            f"(ROADMAP.md, Queue 1 item 6)")
    if cfg.param_dtype != "float32":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.param_dtype} master weights are not ported "
            f"yet (ROADMAP.md, Queue 1 item 6)")
    if cache and cfg.kv_cache_dtype != "bfloat16":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.kv_cache_dtype} KV cache is not ported "
            f"yet (ROADMAP.md, Queue 1 item 6)")


# ---------------------------------------------------------------------------
# init / weights from the reference
# ---------------------------------------------------------------------------


def _layer_init(gen: torch.Generator, cfg: TransformerConfig) -> Params:
    return {"ln1": rmsnorm_init(cfg.d_model, gen.device),
            "ln2": rmsnorm_init(cfg.d_model, gen.device),
            "attn": attn.gqa_init(gen, cfg),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type)}


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random weights at ``cfg``'s shapes, drawn from a ``torch.Generator``
    seeded with ``seed`` on the device."""
    _check(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p: Params = {
        "embed": normal(gen, (cfg.vocab_size, cfg.d_model)) * 0.02,
        "ln_f": rmsnorm_init(cfg.d_model, dev),
        "layers": [_layer_init(gen, cfg) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        p["out"] = dense_init(gen, cfg.d_model, cfg.vocab_size)
    return p


def params_from_numpy(cfg: TransformerConfig, tree: Params,
                      device: DeviceLike = None) -> Params:
    """The reference's parameter tree (numpy arrays; ``layers`` stacked
    along a leading L axis) as the port's params on ``device``."""
    _check(cfg)
    dev = resolve_device(device)
    stacked = tree["layers"]
    p = {k: tree_map(lambda a: from_numpy(a, dev), v)
         for k, v in tree.items() if k != "layers"}
    p["layers"] = [tree_map(lambda a: from_numpy(np.asarray(a)[i], dev),
                            stacked) for i in range(cfg.n_layers)]
    return p


# ---------------------------------------------------------------------------
# forward (prefill-style full sequence)
# ---------------------------------------------------------------------------


def _tokens(params: Params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["embed"].device).long()


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(torch.bfloat16)


def _block(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
           positions: torch.Tensor, return_kv: bool = False):
    """One layer; with ``return_kv`` also its rotated k and v."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    a, k, v = attn.gqa_forward(lp["attn"], h, cfg, positions,
                               return_kv=True)
    x = x + a
    h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    x = x + mlp(lp["mlp"], h, cfg.mlp_type)
    return (x, k, v) if return_kv else x


def forward_hidden(cfg: TransformerConfig, params: Params, tokens
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (final hidden (B,S,d) post-norm, aux loss 0)."""
    _check(cfg)
    tokens = _tokens(params, tokens)
    b, s = tokens.shape
    x = _embed(params, tokens)
    positions = torch.arange(s, device=x.device).expand(b, s)
    for lp in params["layers"]:
        x = _block(cfg, lp, x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux


def forward(cfg: TransformerConfig, params: Params, tokens
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (logits f32 (B,S,V), total aux loss)."""
    x, aux = forward_hidden(cfg, params, tokens)
    return _head_logits(cfg, params, x), aux


def _head_logits(cfg: TransformerConfig, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x.float() @ params["embed"].float().T
    return dense(params["out"], x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


class LMCache:
    """KV cache container: ``kind`` ("gqa") and ``data``, the stacked
    (L, B, Smax, KV, hd) bf16 k and v caches."""

    def __init__(self, kind: str, data: Tuple[torch.Tensor, ...]):
        self.kind = kind
        self.data = tuple(data)

    def __repr__(self):
        return f"LMCache({self.kind}, {[tuple(a.shape) for a in self.data]})"


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> LMCache:
    _check(cfg, cache=True)
    c = attn.init_kv_cache(cfg, batch, max_seq, device)
    return LMCache("gqa", (c.k, c.v))


def _pad_seq(x: torch.Tensor, max_seq: int) -> torch.Tensor:
    s = x.shape[1]
    if s == max_seq:
        return x
    pad = x.new_zeros((x.shape[0], max_seq - s) + tuple(x.shape[2:]))
    return torch.cat([x, pad], 1)


def prefill(cfg: TransformerConfig, params: Params, tokens,
            max_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, LMCache]:
    """Process the prompt; return last-position logits (B,V) f32 and a
    cache of length ``max_seq`` (default: the prompt length)."""
    _check(cfg, cache=True)
    tokens = _tokens(params, tokens)
    b, s = tokens.shape
    max_seq = max_seq or s
    x = _embed(params, tokens)
    positions = torch.arange(s, device=x.device).expand(b, s)
    ks, vs = [], []
    for lp in params["layers"]:
        x, k, v = _block(cfg, lp, x, positions, return_kv=True)
        ks.append(_pad_seq(k.to(torch.bfloat16), max_seq))
        vs.append(_pad_seq(v.to(torch.bfloat16), max_seq))
    x = rmsnorm(params["ln_f"], x[:, -1:, :], cfg.norm_eps)
    logits = _head_logits(cfg, params, x)
    return logits[:, 0], LMCache("gqa", (torch.stack(ks), torch.stack(vs)))


def decode_step(cfg: TransformerConfig, params: Params, cache: LMCache,
                token, pos) -> Tuple[torch.Tensor, LMCache]:
    """token (B,1), pos (int) -> (logits (B,V) f32, the cache written in
    place at ``pos``)."""
    _check(cfg, cache=True)
    pos = int(pos)
    x = _embed(params, _tokens(params, token))
    k_all, v_all = cache.data
    for i, lp in enumerate(params["layers"]):
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        x = x + attn.gqa_decode(lp["attn"], h, cfg, k_all[i], v_all[i], pos)
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + mlp(lp["mlp"], h2, cfg.mlp_type)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return _head_logits(cfg, params, x)[:, 0], cache
