"""Attention: GQA over the flash kernel, and decode steps over a bf16 KV
cache (port of the GQA part of ``repro.models.attention``).

``gqa_forward`` runs its attention block through
``kernels.ops.flash_attention`` (the CUDA kernel on the card, its plain
f32 softmax on the CPU), where the reference runs the chunked jnp path
``_causal_chunk_attn`` and names the Pallas flash kernel as its TPU
replacement.  On the card the bf16 kernel rounds the probabilities to
bf16 before P V, as the chunked path does; only the plain version on the
CPU keeps P in f32, so there the port agrees with the reference at bf16
tolerance.

The reference's sharding annotations (``act``) have no meaning on one
device and are gone.  MLA and the int8 KV cache wait (``ROADMAP.md``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import TransformerConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense, dense_init

Params = Dict[str, torch.Tensor]
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def gqa_init(gen: torch.Generator, cfg: TransformerConfig) -> Params:
    d, hd = cfg.d_model, cfg.head_dim()
    return {
        "wq": dense_init(gen, d, cfg.n_heads * hd, bias=cfg.qkv_bias),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.n_heads * hd, d),
    }


def _heads_flat(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B*H, S, hd), the kernel's layout."""
    b, s, h, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, hd)


def gqa_forward(p: Params, x: torch.Tensor, cfg: TransformerConfig,
                positions: torch.Tensor, *, return_kv: bool = False):
    """x (B, S, d) bf16 -> (B, S, d).  With ``return_kv``, also the
    (B, S, KV, hd) roped k and v the prefill caches (the reference
    recomputes them; they are the same values)."""
    b, s, _ = x.shape
    hd, h, kv = cfg.head_dim(), cfg.n_heads, cfg.n_kv_heads
    g = h // kv
    q = dense(p["wq"], x).reshape(b, s, h, hd)
    k = dense(p["wk"], x).reshape(b, s, kv, hd)
    v = dense(p["wv"], x).reshape(b, s, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # repeat the KV heads to H: head i reads KV head i // g
    kr = k.repeat_interleave(g, dim=2) if g > 1 else k
    vr = v.repeat_interleave(g, dim=2) if g > 1 else v
    o = ops.flash_attention(_heads_flat(q), _heads_flat(kr), _heads_flat(vr),
                            causal=True)
    o = o.reshape(b, h, s, hd).permute(0, 2, 1, 3).reshape(b, s, h * hd)
    out = dense(p["wo"], o)
    return (out, k, v) if return_kv else out


# ---------------------------------------------------------------------------
# KV cache (bf16) + decode
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor                  # (L,B,Smax,KV,hd) bf16
    v: torch.Tensor


def init_kv_cache(cfg: TransformerConfig, batch: int, max_seq: int,
                  device: DeviceLike = None) -> KVCache:
    """Zeroed bf16 k and v caches (the int8 cache is not ported yet), on
    the card unless given ``device="cpu"``."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim())
    return KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   torch.zeros(shape, dtype=torch.bfloat16, device=device))


def cache_update(layer_k: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """Write (B,1,KV,hd) at seq position ``pos`` of (B,Smax,KV,hd), in
    place (the reference's dynamic_update_slice returns a new array)."""
    layer_k[:, pos: pos + 1] = new.to(layer_k.dtype)


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos: int) -> torch.Tensor:
    """q:(B,1,KV,G,hd); caches (B,Smax,KV,hd) -> (B,1,KV,G,hd).

    The reference's bf16 einsums with f32 accumulation: bf16 operands
    are upcast to f32 before each product, so the logits are not
    rounded to bf16; the probabilities are rounded to bf16 before P V.
    """
    hd = q.shape[-1]
    smax = k_cache.shape[1]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs",
                          q.to(torch.bfloat16).float(),
                          k_cache.to(torch.bfloat16).float()) * scale
    mask = (torch.arange(smax, device=q.device) <= pos)[None, None, None,
                                                       None, :]
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(torch.bfloat16).float(),
                       v_cache.to(torch.bfloat16).float())
    return out.to(q.dtype)


def gqa_decode(p: Params, x: torch.Tensor, cfg: TransformerConfig,
               layer_k: torch.Tensor, layer_v: torch.Tensor,
               pos: int) -> torch.Tensor:
    """x: (B,1,d); this layer's caches (B,Smax,KV,hd), updated in place
    at ``pos``."""
    b = x.shape[0]
    hd, h, kv = cfg.head_dim(), cfg.n_heads, cfg.n_kv_heads
    g = h // kv
    q = dense(p["wq"], x).reshape(b, 1, h, hd)
    k = dense(p["wk"], x).reshape(b, 1, kv, hd)
    v = dense(p["wv"], x).reshape(b, 1, kv, hd)
    posv = torch.full((b, 1), pos, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta).reshape(b, 1, kv, g, hd)
    k = apply_rope(k, posv, cfg.rope_theta)
    cache_update(layer_k, k, pos)
    cache_update(layer_v, v, pos)
    o = decode_attn(q, layer_k, layer_v, pos)
    return dense(p["wo"], o.reshape(b, 1, h * hd))
