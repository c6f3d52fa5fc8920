"""Attention: GQA and MLA over the flash kernel, and decode steps over
bf16 or int8 KV caches and the MLA latent cache (port of
``repro.models.attention``).

``gqa_forward`` and ``mla_forward`` run their attention block through
``kernels.ops.flash_attention`` (the CUDA kernel on the card, its plain
f32 softmax on the CPU), where the reference runs the chunked jnp path
``_causal_chunk_attn`` and names the Pallas flash kernel as its TPU
replacement.  MLA attends with a qk head dim (nope + rope) other than
its v head dim; the kernel takes both.  On the card the bf16 kernel
rounds the probabilities to bf16 before P V, as the chunked path does;
only the plain version on the CPU keeps P in f32, so there the port
agrees with the reference at bf16 tolerance.

Both run under autograd: ``ops.flash_attention``'s backward is the
gradient of the reference's ``_causal_chunk_attn`` at the config's
``attn_chunk`` (see ``kernels.flash_attention``).  ``_causal_chunk_attn``
itself is ported as the plain path: inside :func:`plain_attention` the
two forwards attend through it, and autograd differentiates its plain
ops, the path the kernel's is held against (tests, ``chip_smoke.py``).
The GQA repeat of the KV heads is an ``expand``, whose backward is a
sum (no scatter).

The reference's sharding annotations (``act``) have no meaning on one
device and are gone.  Caches are written in place where the reference
returns updated arrays.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import MLAConfig, TransformerConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, dense, dense_init,
                                       rmsnorm, rmsnorm_init)

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


def _causal_chunk_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       chunk: int) -> torch.Tensor:
    """Flat-head chunked causal attention, the reference's: q, k
    (B,S,H,dqk), v (B,S,H,dv) -> (B,S,H,dv) in v's dtype.  Per query
    block of ``chunk``: f32 logits scaled by 1/sqrt(dqk), the causal
    mask at -1e30, an f32 softmax, P in v's dtype before P V.  The
    reference pads the last block's queries and drops their rows; here
    the last block is shorter (the same rows)."""
    s, dqk = q.shape[1], q.shape[-1]
    chunk = min(chunk, s)
    scale = 1.0 / math.sqrt(dqk)
    kf = k.float()
    kpos = torch.arange(k.shape[1], device=q.device)
    out = []
    for r0 in range(0, s, chunk):
        qi = q[:, r0: r0 + chunk]
        qpos = torch.arange(r0, r0 + qi.shape[1], device=q.device)
        logits = torch.einsum("bchd,bshd->bhcs", qi.float(), kf) * scale
        mask = kpos[None, :] <= qpos[:, None]           # (chunk, S)
        logits = torch.where(mask[None, None], logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        out.append(torch.einsum("bhcs,bshv->bchv", p.to(v.dtype), v))
    return torch.cat(out, 1)


_plain: List[bool] = []


@contextmanager
def plain_attention():
    """While open, ``gqa_forward`` and ``mla_forward`` attend through
    :func:`_causal_chunk_attn` instead of the flash kernel: the plain
    path, differentiated by autograd."""
    _plain.append(True)
    try:
        yield
    finally:
        _plain.pop()


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            chunk: int) -> torch.Tensor:
    """Causal attention of (B,S,H,dqk) q, k and (B,S,H,dv) v ->
    (B,S,H*dv): the flash kernel's Function, or inside
    :func:`plain_attention` the plain chunked path."""
    b, s, h, dv = v.shape
    if _plain:
        return _causal_chunk_attn(q, k, v, chunk).reshape(b, s, h * dv)
    o = ops.flash_attention(_heads_flat(q), _heads_flat(k), _heads_flat(v),
                            causal=True, chunk=chunk)
    return o.reshape(b, h, s, dv).permute(0, 2, 1, 3).reshape(b, s, h * dv)


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
    kr, vr = ((t[:, :, :, None].expand(b, s, kv, g, hd).reshape(b, s, h, hd)
               if g > 1 else t) for t in (k, v))
    out = dense(p["wo"], _attend(q, kr, vr, cfg.attn_chunk))
    return (out, k, v) if return_kv else out


# ---------------------------------------------------------------------------
# KV cache (bf16 / int8) + decode
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor                  # (L,B,Smax,KV,hd) bf16 or int8
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]  # (L,B,Smax,KV) f32 (int8 only)
    v_scale: Optional[torch.Tensor]


def init_kv_cache(cfg: TransformerConfig, batch: int, max_seq: int,
                  device: DeviceLike = None) -> KVCache:
    """Zeroed k and v caches, bf16, or int8 with f32 scales of one when
    ``cfg.kv_cache_dtype`` is "int8", on the card unless given
    ``device="cpu"``.  Every array is its own tensor (the caches are
    written in place)."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim())
    if cfg.kv_cache_dtype == "int8":
        return KVCache(*(torch.zeros(shape, dtype=torch.int8, device=device)
                         for _ in range(2)),
                       *(torch.ones(shape[:-1], dtype=torch.float32,
                                    device=device) for _ in range(2)))
    return KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   None, None)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> int8 data + per-vector f32 scale.  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(torch.bfloat16)


def cache_update(layer_k: torch.Tensor, layer_scale: Optional[torch.Tensor],
                 new: torch.Tensor, pos: int) -> None:
    """Write (B,1,KV,hd) at seq position ``pos`` of (B,Smax,KV,hd), in
    place (the reference's dynamic_update_slice returns a new array):
    quantized, with its scale written into ``layer_scale``, for an int8
    cache."""
    if layer_scale is not None:
        new, sc = quantize_kv(new)
        layer_scale[:, pos: pos + 1] = sc
    layer_k[:, pos: pos + 1] = new.to(layer_k.dtype)


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                pos: int, k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q:(B,1,KV,G,hd); caches (B,Smax,KV,hd) -> (B,1,KV,G,hd).

    The reference's bf16 einsums with f32 accumulation: bf16 operands
    are upcast to f32 before each product, so the logits are not
    rounded to bf16; the probabilities are rounded to bf16 before P V.
    An int8 cache's (B,Smax,KV) scales are folded in the reference's
    order: the k scales after the QK dot, the v scales into the
    probabilities, so the dequantized cache is never built.
    """
    hd = q.shape[-1]
    smax = k_cache.shape[1]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs",
                          q.to(torch.bfloat16).float(),
                          k_cache.to(torch.bfloat16).float()) * scale
    if k_scale is not None:
        logits = logits * k_scale.float().movedim(1, 2)[:, :, None, None, :]
    mask = (torch.arange(smax, device=q.device) <= pos)[None, None, None,
                                                       None, :]
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        p = p * v_scale.float().movedim(1, 2)[:, :, None, None, :]
    out = torch.einsum("bkgqs,bskh->bqkgh", p.to(torch.bfloat16).float(),
                       v_cache.to(torch.bfloat16).float())
    return out.to(q.dtype)


def gqa_decode(p: Params, x: torch.Tensor, cfg: TransformerConfig,
               layer_k: torch.Tensor, layer_v: torch.Tensor, pos: int,
               k_scale: Optional[torch.Tensor] = None,
               v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B,1,d); this layer's caches (B,Smax,KV,hd), and for an int8
    cache their (B,Smax,KV) scales, updated in place at ``pos``."""
    b = x.shape[0]
    hd, h, kv = cfg.head_dim(), cfg.n_heads, cfg.n_kv_heads
    g = h // kv
    q = dense(p["wq"], x).reshape(b, 1, h, hd)
    k = dense(p["wk"], x).reshape(b, 1, kv, hd)
    v = dense(p["wv"], x).reshape(b, 1, kv, hd)
    posv = torch.full((b, 1), pos, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta).reshape(b, 1, kv, g, hd)
    k = apply_rope(k, posv, cfg.rope_theta)
    cache_update(layer_k, k_scale, k, pos)
    cache_update(layer_v, v_scale, v, pos)
    o = decode_attn(q, layer_k, layer_v, pos, k_scale, v_scale)
    return dense(p["wo"], o.reshape(b, 1, h * hd))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-style latent attention) — MiniCPM3
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg: TransformerConfig) -> Params:
    m = cfg.mla or MLAConfig()
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = gen.device
    return {
        "wq_a": dense_init(gen, d, m.q_lora_rank),
        "q_norm": rmsnorm_init(m.q_lora_rank, dev),
        "wq_b": dense_init(gen, m.q_lora_rank, h * qk),
        "wkv_a": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, dev),
        "wk_b": dense_init(gen, m.kv_lora_rank, h * m.qk_nope_head_dim),
        "wv_b": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim),
        "wo": dense_init(gen, h * m.v_head_dim, d),
    }


def _mla_qkv(p: Params, x: torch.Tensor, cfg: TransformerConfig,
             positions: torch.Tensor):
    """x (B,S,d) -> q_nope (B,S,H,nope), roped q_rope (B,S,H,rope), the
    normed latent ckv (B,S,r) and the roped shared k_rope (B,S,1,rope)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    cq = rmsnorm(p["q_norm"], dense(p["wq_a"], x))
    q = dense(p["wq_b"], cq).reshape(
        b, s, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope = q[..., : m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    kv = dense(p["wkv_a"], x)
    ckv = rmsnorm(p["kv_norm"], kv[..., : m.kv_lora_rank])
    k_rope = apply_rope(kv[..., m.kv_lora_rank:][:, :, None, :], positions,
                        cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope


def mla_forward(p: Params, x: torch.Tensor, cfg: TransformerConfig,
                positions: torch.Tensor, *, return_latent: bool = False):
    """x (B,S,d) bf16 -> (B,S,d): the latent expanded to per-head K and
    V, then causal attention through the flash kernel at a qk head dim
    of nope + rope and a v head dim of ``v_head_dim``.  With
    ``return_latent``, also the (B,S,r) ckv and (B,S,rope) k_rope the
    prefill caches."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, x, cfg, positions)
    k_nope = dense(p["wk_b"], ckv).reshape(b, s, h, m.qk_nope_head_dim)
    v = dense(p["wv_b"], ckv).reshape(b, s, h, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_head_dim)], -1)
    out = dense(p["wo"], _attend(q, k, v, cfg.attn_chunk))
    return (out, ckv, k_rope[:, :, 0]) if return_latent else out


class MLACache(NamedTuple):
    ckv: torch.Tensor     # (L,B,Smax,r) bf16
    k_rope: torch.Tensor  # (L,B,Smax,rope) bf16


def init_mla_cache(cfg: TransformerConfig, batch: int, max_seq: int,
                   device: DeviceLike = None) -> MLACache:
    """Zeroed bf16 latent caches, on the card unless given
    ``device="cpu"``."""
    device = resolve_device(device)
    m = cfg.mla
    return MLACache(
        torch.zeros((cfg.n_layers, batch, max_seq, m.kv_lora_rank),
                    dtype=torch.bfloat16, device=device),
        torch.zeros((cfg.n_layers, batch, max_seq, m.qk_rope_head_dim),
                    dtype=torch.bfloat16, device=device))


def mla_decode(p: Params, x: torch.Tensor, cfg: TransformerConfig,
               ckv_c: torch.Tensor, kr_c: torch.Tensor,
               pos: int) -> torch.Tensor:
    """Absorbed-matrix MLA decode: x (B,1,d); this layer's (B,Smax,r)
    ckv and (B,Smax,rope) k_rope caches, written in place at ``pos``.
    W_uk is absorbed into the query and W_uv applied after the
    attention, so it runs in the latent space, in f32 einsums as the
    reference's."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    posv = torch.full((b, 1), pos, device=x.device)
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, x, cfg, posv)
    ckv_c[:, pos: pos + 1] = ckv.to(ckv_c.dtype)
    kr_c[:, pos: pos + 1] = k_rope[:, :, 0].to(kr_c.dtype)
    wk_b = p["wk_b"]["w"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    # absorb W_uk into the query:  q_lat[b,h,r] = q_nope . W_uk
    q_lat = torch.einsum("bqhn,rhn->bhqr", q_nope.float(), wk_b.float())
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    ckv_f = ckv_c.float()
    logits = (torch.einsum("bhqr,bsr->bhqs", q_lat, ckv_f)
              + torch.einsum("bqhp,bsp->bhqs", q_rope.float(),
                             kr_c.float())) * scale
    smax = ckv_c.shape[1]
    mask = (torch.arange(smax, device=x.device) <= pos)[None, None, None, :]
    logits = torch.where(mask, logits, NEG_INF)
    prob = torch.softmax(logits, dim=-1)
    lat = torch.einsum("bhqs,bsr->bhqr", prob, ckv_f)
    wv_b = p["wv_b"]["w"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    o = torch.einsum("bhqr,rhv->bqhv", lat, wv_b.float())
    return dense(p["wo"], o.reshape(b, 1, h * m.v_head_dim)
                 .to(torch.bfloat16))
