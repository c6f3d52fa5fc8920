"""Decoder-only LM: GQA or MLA attention, dense or MoE FFNs, bf16 or
int8 KV caches, training and serving (port of
``repro.models.transformer``).

Entry points:
  init_params(cfg, seed, device=None)        -> params
  params_from_numpy(cfg, tree, device=None)  -> params from a reference tree
  train_state_from_numpy(cfg, state, device=None) -> a training state
  loss_fn(cfg, params, batch)                -> (loss, {"ce", "aux"})
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
``decode_step`` writes the cache in place.  ``loss_fn`` runs every
layer under activation checkpointing (``torch.utils.checkpoint``, not
reentrant; ``remat_policy="dots"`` saves the matrix products' outputs,
as ``jax.checkpoint_policies.dots_saveable``) and the cross-entropy in
chunks of tokens whose head product is recomputed in the backward, so
the (B, S, V) logits never exist; the flash kernel runs again in each
layer's recompute.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import TransformerConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (dense, dense_init, from_numpy,
                                       gather_rows, mlp, mlp_init, normal,
                                       rmsnorm, rmsnorm_init, tree_map)

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


def _mirrors(tree, params) -> bool:
    """Whether ``tree`` has ``params``' structure, an array of each
    parameter's shape at each of its leaves."""
    if isinstance(params, dict):
        return isinstance(tree, dict) and set(tree) == set(params) and \
            all(_mirrors(tree[k], params[k]) for k in params)
    return hasattr(tree, "shape") and tuple(tree.shape) == \
        tuple(np.shape(params))


def train_state_from_numpy(cfg: TransformerConfig, state,
                           device: DeviceLike = None):
    """The reference's training state ``(params, opt_state, step)``
    (numpy arrays, layers stacked) as the port's, on ``device``.  The
    optimizer state must mirror the params, as AdamW's ``{"mu", "nu"}``
    and SGDM's momentum do; each of its trees is unstacked as the
    params are.  Adafactor's factored state of a stacked leaf spans the
    layers, which the port keeps apart, and does not carry across."""
    params, opt_state, step = state
    dev = resolve_device(device)
    if isinstance(opt_state, dict) and set(opt_state) == {"mu", "nu"} and \
            all(_mirrors(v, params) for v in opt_state.values()):
        opt = {k: params_from_numpy(cfg, v, dev)
               for k, v in opt_state.items()}
    elif _mirrors(opt_state, params):
        opt = params_from_numpy(cfg, opt_state, dev)
    else:
        raise ValueError("train_state_from_numpy carries an optimizer state "
                         "that mirrors the params (AdamW's mu and nu, "
                         "SGDM's momentum)")
    step = torch.tensor(np.array(step), dtype=torch.int32, device=dev)
    return params_from_numpy(cfg, params, dev), opt, step


class Blocks(NamedTuple):
    """The functions a layer runs: attention over a sequence and for one
    decode step (GQA or MLA) and the MoE FFN.  ``BLOCKS`` are the
    models' own; a caller may pass others of the same signatures to
    ``forward``, ``loss_fn``, ``prefill`` and ``decode_step``."""
    gqa_forward: Callable
    mla_forward: Callable
    gqa_decode: Callable
    mla_decode: Callable
    moe_forward: Callable


BLOCKS = Blocks(attn.gqa_forward, attn.mla_forward, attn.gqa_decode,
                attn.mla_decode, moe_lib.moe_forward)


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
    return gather_rows(params["embed"], tokens).to(torch.bfloat16)


def _ffn(cfg: TransformerConfig, lp: Params, h: torch.Tensor,
         dense_ffn: bool, blocks: Blocks
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN on h: (out, aux loss)."""
    if "moe" in lp and not dense_ffn:
        return blocks.moe_forward(lp["moe"], h, cfg)
    return mlp(lp["mlp"], h, cfg.mlp_type), \
        torch.zeros((), dtype=torch.float32, device=h.device)


def _block(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
           positions: torch.Tensor, *, dense_ffn: bool, blocks: Blocks):
    """One layer: (x, aux loss, kv), kv what the prefill caches: the
    (B,S,KV,hd) roped k and v, or MLA's (B,S,r) ckv and (B,S,rope)
    k_rope (the reference recomputes them; they are the same values)."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, *kv = blocks.mla_forward(lp["attn"], h, cfg, positions,
                                    return_latent=True)
    else:
        a, *kv = blocks.gqa_forward(lp["attn"], h, cfg, positions,
                                    return_kv=True)
    x = x + a
    h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    f, aux = _ffn(cfg, lp, h, dense_ffn, blocks)
    return x + f, aux, kv


# the ops whose outputs remat_policy="dots" saves: the matrix products
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(cfg: TransformerConfig, lp: Params, x: torch.Tensor,
                 positions: torch.Tensor, dense_ffn: bool, blocks: Blocks):
    """One layer under activation checkpointing: (x, aux)."""
    def body(lp, x):
        x, aux, _ = _block(cfg, lp, x, positions, dense_ffn=dense_ffn,
                           blocks=blocks)
        return x, aux

    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable)
    return checkpoint(body, lp, x, use_reentrant=False, **kw)


def forward_hidden(cfg: TransformerConfig, params: Params, tokens, *,
                   remat: bool = False, blocks: Blocks = BLOCKS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (final hidden (B,S,d) post-norm, summed aux loss).
    With ``remat``, each layer runs under activation checkpointing."""
    tokens = _tokens(params, tokens)
    b, s = tokens.shape
    x = _embed(params, tokens)
    positions = torch.arange(s, device=x.device).expand(b, s)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, dense_ffn in _all_layers(cfg, params):
        # the reference checkpoints the scanned layers, not the leading
        # dense ones
        if remat and not dense_ffn:
            x, aux = _remat_block(cfg, lp, x, positions, dense_ffn, blocks)
        else:
            x, aux, _ = _block(cfg, lp, x, positions, dense_ffn=dense_ffn,
                               blocks=blocks)
        aux_total = aux_total + aux
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux_total


def forward(cfg: TransformerConfig, params: Params, tokens, *,
            blocks: Blocks = BLOCKS) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (logits f32 (B,S,V), total aux loss)."""
    x, aux = forward_hidden(cfg, params, tokens, blocks=blocks)
    return _head_logits(cfg, params, x), aux


def _head_logits(cfg: TransformerConfig, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    """f32 logits; a tied bf16 embedding is widened to f32 first, as
    JAX promotes f32 @ bf16."""
    if cfg.tie_embeddings:
        return x.float() @ params["embed"].float().T
    return dense(params["out"], x, dtype=torch.float32)


def loss_fn(cfg: TransformerConfig, params: Params, batch: Dict, *,
            ce_chunk: int = 512, blocks: Blocks = BLOCKS
            ) -> Tuple[torch.Tensor, Dict]:
    """Chunked cross-entropy plus the MoE aux loss: (loss, {"ce",
    "aux"}).  ``batch`` holds (B,S) ``tokens`` and ``labels`` (a label
    under 0 is masked).  The layers run under remat; the head product
    and CE run per (B, ce_chunk) token slab under a checkpoint that
    saves nothing (the reference's ``nothing_saveable``), so the peak
    extra memory is one slab's B * ce_chunk * V logits."""
    hidden, aux = forward_hidden(cfg, params, batch["tokens"], remat=True,
                                 blocks=blocks)
    b, s, _ = hidden.shape
    labels = torch.as_tensor(batch["labels"], device=hidden.device).long()
    mask = (labels >= 0).float()
    chunk = min(ce_chunk, s)
    if s % chunk != 0:
        chunk = s

    def chunk_nll(xc, labc, mkc):
        logits = _head_logits(cfg, params, xc)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labc[..., None])[..., 0]
        return ((lse - gold) * mkc).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    lab = labels.clamp_min(0)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(chunk_nll, hidden[:, sl], lab[:, sl],
                                   mask[:, sl], use_reentrant=False)
    ce = total / torch.clamp_min(mask.sum(), 1.0)
    return ce + aux, {"ce": ce, "aux": aux}


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
            max_seq: Optional[int] = None, *, blocks: Blocks = BLOCKS
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
        x, _, kv = _block(cfg, lp, x, positions, dense_ffn=dense_ffn,
                          blocks=blocks)
        entries.append(_cache_entry(kind, kv, max_seq))
    x = rmsnorm(params["ln_f"], x[:, -1:, :], cfg.norm_eps)
    logits = _head_logits(cfg, params, x)
    return logits[:, 0], LMCache(kind, tuple(torch.stack(c)
                                             for c in zip(*entries)))


def decode_step(cfg: TransformerConfig, params: Params, cache: LMCache,
                token, pos, *, blocks: Blocks = BLOCKS
                ) -> Tuple[torch.Tensor, LMCache]:
    """token (B,1), pos (int) -> (logits (B,V) f32, the cache written in
    place at ``pos``)."""
    pos = int(pos)
    x = _embed(params, _tokens(params, token))
    for i, (lp, dense_ffn) in enumerate(_all_layers(cfg, params)):
        layer = tuple(c[i] for c in cache.data)
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if cache.kind == "mla":
            a = blocks.mla_decode(lp["attn"], h, cfg, *layer, pos)
        else:
            k, v, *scales = layer
            a = blocks.gqa_decode(lp["attn"], h, cfg, k, v, pos, *scales)
        x = x + a
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + _ffn(cfg, lp, h2, dense_ffn, blocks)[0]
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return _head_logits(cfg, params, x)[:, 0], cache
