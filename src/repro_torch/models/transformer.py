"""Decoder-only LM serving: GQA or MLA attention, dense or MoE FFNs,
bf16 or int8 KV caches (port of the serving path of
``repro.models.transformer``).

Entry points:
  init_params(cfg, seed, device=None)        -> params
  params_from_numpy(cfg, tree, device=None)  -> params from a reference tree
  forward(cfg, params, tokens)               -> (logits f32 (B,S,V), aux)
  prefill(cfg, params, tokens, max_seq)      -> (last logits (B,V), LMCache)
  decode_step(cfg, params, cache, token, pos) -> (logits (B,V), cache)

Params are a dict: ``embed`` (V, d), ``ln_f``, optional ``out``,
``dense_layer_{i}`` for an MoE config's ``first_k_dense`` leading dense
layers, and ``layers``, a list of the other layers' dicts (the
reference stacks them along a leading axis for ``lax.scan``; here the
layer loop is a Python loop).  Weights are f32, or bf16 when
``cfg.param_dtype`` is "bfloat16", and every ``dense`` casts them to
its compute type on use, as the reference does.  ``prefill`` and
``decode_step`` run where the params lie; ``init_params`` and
``params_from_numpy`` run on the card unless given ``device="cpu"``.
``decode_step`` writes the cache in place.  Training (``loss_fn``) is
not ported yet (``ROADMAP.md``, Queue 1 item 6).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import TransformerConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (dense, dense_init, from_numpy, mlp,
                                       mlp_init, normal, rmsnorm,
                                       rmsnorm_init, tree_map)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init / weights from the reference
# ---------------------------------------------------------------------------


def _n_dense(cfg: TransformerConfig) -> int:
    return cfg.moe.first_k_dense if cfg.moe else 0


def _master(cfg: TransformerConfig, tree):
    """``tree`` in the config's master-weight type: every f32 leaf cast
    to bf16 when ``cfg.param_dtype`` is "bfloat16"."""
    if cfg.param_dtype != "bfloat16":
        return tree
    return tree_map(lambda t: t.to(torch.bfloat16)
                    if t.dtype == torch.float32 else t, tree)


def _layer_init(gen: torch.Generator, cfg: TransformerConfig, *,
                dense_ffn: bool) -> Params:
    dev = gen.device
    p: Params = {"ln1": rmsnorm_init(cfg.d_model, dev),
                 "ln2": rmsnorm_init(cfg.d_model, dev)}
    p["attn"] = attn.mla_init(gen, cfg) if cfg.attn_type == "mla" \
        else attn.gqa_init(gen, cfg)
    if cfg.moe is not None and not dense_ffn:
        p["moe"] = moe_lib.moe_init(gen, cfg)
    else:
        d_ff = cfg.moe.d_ff_dense if (cfg.moe and dense_ffn) else cfg.d_ff
        p["mlp"] = mlp_init(gen, cfg.d_model, d_ff, cfg.mlp_type)
    return _master(cfg, p)


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random weights at ``cfg``'s shapes, drawn from a ``torch.Generator``
    seeded with ``seed`` on the device, in the config's master-weight
    type (each layer is cast as it is drawn, so the f32 copy of the whole
    model never exists)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_dense = _n_dense(cfg)
    p: Params = {
        "embed": _master(cfg, normal(gen, (cfg.vocab_size, cfg.d_model))
                         * 0.02),
        "ln_f": _master(cfg, rmsnorm_init(cfg.d_model, dev)),
        "layers": [_layer_init(gen, cfg, dense_ffn=False)
                   for _ in range(cfg.n_layers - n_dense)],
    }
    for i in range(n_dense):
        p[f"dense_layer_{i}"] = _layer_init(gen, cfg, dense_ffn=True)
    if not cfg.tie_embeddings:
        p["out"] = _master(cfg, dense_init(gen, cfg.d_model,
                                           cfg.vocab_size))
    return p


def params_from_numpy(cfg: TransformerConfig, tree: Params,
                      device: DeviceLike = None) -> Params:
    """The reference's parameter tree (numpy arrays; ``layers`` stacked
    along a leading axis) as the port's params on ``device``, each leaf
    in its own dtype (bf16 leaves bit for bit)."""
    dev = resolve_device(device)
    stacked = tree["layers"]
    p = {k: tree_map(lambda a: from_numpy(a, dev), v)
         for k, v in tree.items() if k != "layers"}
    n = cfg.n_layers - _n_dense(cfg)
    p["layers"] = [tree_map(lambda a: from_numpy(np.asarray(a)[i], dev),
                            stacked) for i in range(n)]
    return p


def _all_layers(cfg: TransformerConfig,
                params: Params) -> List[Tuple[Params, bool]]:
    """Every layer in order with its ``dense_ffn`` flag: the leading
    dense layers of an MoE config, then ``layers``."""
    return [(params[f"dense_layer_{i}"], True)
            for i in range(_n_dense(cfg))] + \
        [(lp, False) for lp in params["layers"]]


# ---------------------------------------------------------------------------
# forward (prefill-style full sequence)
# ---------------------------------------------------------------------------


def _tokens(params: Params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["embed"].device).long()


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens].to(torch.bfloat16)


def _ffn(cfg: TransformerConfig, lp: Params, h: torch.Tensor,
         dense_ffn: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN on h: (out, aux loss)."""
    if "moe" in lp and not dense_ffn:
        return moe_lib.moe_forward(lp["moe"], h, cfg)
    return mlp(lp["mlp"], h, cfg.mlp_type), \
        torch.zeros((), dtype=torch.float32, device=h.device)


def _block(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
           positions: torch.Tensor, *, dense_ffn: bool):
    """One layer: (x, aux loss, kv), kv what the prefill caches: the
    (B,S,KV,hd) roped k and v, or MLA's (B,S,r) ckv and (B,S,rope)
    k_rope (the reference recomputes them; they are the same values)."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, *kv = attn.mla_forward(lp["attn"], h, cfg, positions,
                                  return_latent=True)
    else:
        a, *kv = attn.gqa_forward(lp["attn"], h, cfg, positions,
                                  return_kv=True)
    x = x + a
    h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    f, aux = _ffn(cfg, lp, h, dense_ffn)
    return x + f, aux, kv


def forward_hidden(cfg: TransformerConfig, params: Params, tokens
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (final hidden (B,S,d) post-norm, summed aux loss)."""
    tokens = _tokens(params, tokens)
    b, s = tokens.shape
    x = _embed(params, tokens)
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, dense_ffn in _all_layers(cfg, params):
        x, aux, _ = _block(cfg, lp, x, positions, dense_ffn=dense_ffn)
        aux_total = aux_total + aux
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux_total


def forward(cfg: TransformerConfig, params: Params, tokens
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (logits f32 (B,S,V), total aux loss)."""
    x, aux = forward_hidden(cfg, params, tokens)
    return _head_logits(cfg, params, x), aux


def _head_logits(cfg: TransformerConfig, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    """f32 logits; a tied bf16 embedding is widened to f32 first, as
    JAX promotes f32 @ bf16."""
    if cfg.tie_embeddings:
        return x.float() @ params["embed"].float().T
    return dense(params["out"], x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


class LMCache:
    """KV cache container: ``kind`` and ``data``, the stacked (L, ...)
    cache arrays: "gqa" (k, v) bf16 (L,B,Smax,KV,hd); "gqa8" the same
    in int8 with their (L,B,Smax,KV) f32 scales (k, v, k_scale,
    v_scale); "mla" the latent (ckv, k_rope) bf16 (L,B,Smax,r|rope)."""

    def __init__(self, kind: str, data: Tuple[torch.Tensor, ...]):
        self.kind = kind
        self.data = tuple(data)

    def __repr__(self):
        return f"LMCache({self.kind}, {[tuple(a.shape) for a in self.data]})"


def _cache_kind(cfg: TransformerConfig) -> str:
    if cfg.attn_type == "mla":
        return "mla"
    return "gqa8" if cfg.kv_cache_dtype == "int8" else "gqa"


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int,
               device: DeviceLike = None) -> LMCache:
    if cfg.attn_type == "mla":
        return LMCache("mla", attn.init_mla_cache(cfg, batch, max_seq,
                                                  device))
    c = attn.init_kv_cache(cfg, batch, max_seq, device)
    return LMCache(_cache_kind(cfg), tuple(a for a in c if a is not None))


def _pad_seq(x: torch.Tensor, max_seq: int) -> torch.Tensor:
    s = x.shape[1]
    if s == max_seq:
        return x
    pad = x.new_zeros((x.shape[0], max_seq - s) + tuple(x.shape[2:]))
    return torch.cat([x, pad], 1)


def _cache_entry(kind: str, kv, max_seq: int) -> Tuple[torch.Tensor, ...]:
    """A layer's cache arrays from what its block returned: bf16 k and
    v, int8 k and v with their scales (the roped k and the raw v
    quantized, as the reference does), or MLA's latents."""
    if kind == "gqa8":
        (kq, ks), (vq, vs) = (attn.quantize_kv(t) for t in kv)
        parts = (kq, vq, ks, vs)
    else:
        parts = tuple(t.to(torch.bfloat16) for t in kv)
    return tuple(_pad_seq(t, max_seq) for t in parts)


def prefill(cfg: TransformerConfig, params: Params, tokens,
            max_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, LMCache]:
    """Process the prompt; return last-position logits (B,V) f32 and a
    cache of length ``max_seq`` (default: the prompt length)."""
    tokens = _tokens(params, tokens)
    b, s = tokens.shape
    max_seq = max_seq or s
    kind = _cache_kind(cfg)
    x = _embed(params, tokens)
    positions = torch.arange(s, device=x.device).expand(b, s)
    entries = []
    for lp, dense_ffn in _all_layers(cfg, params):
        x, _, kv = _block(cfg, lp, x, positions, dense_ffn=dense_ffn)
        entries.append(_cache_entry(kind, kv, max_seq))
    x = rmsnorm(params["ln_f"], x[:, -1:, :], cfg.norm_eps)
    logits = _head_logits(cfg, params, x)
    return logits[:, 0], LMCache(kind, tuple(torch.stack(c)
                                             for c in zip(*entries)))


def decode_step(cfg: TransformerConfig, params: Params, cache: LMCache,
                token, pos) -> Tuple[torch.Tensor, LMCache]:
    """token (B,1), pos (int) -> (logits (B,V) f32, the cache written in
    place at ``pos``)."""
    pos = int(pos)
    x = _embed(params, _tokens(params, token))
    for i, (lp, dense_ffn) in enumerate(_all_layers(cfg, params)):
        layer = tuple(c[i] for c in cache.data)
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if cache.kind == "mla":
            a = attn.mla_decode(lp["attn"], h, cfg, *layer, pos)
        else:
            k, v, *scales = layer
            a = attn.gqa_decode(lp["attn"], h, cfg, k, v, pos, *scales)
        x = x + a
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + _ffn(cfg, lp, h2, dense_ffn)[0]
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return _head_logits(cfg, params, x)[:, 0], cache
