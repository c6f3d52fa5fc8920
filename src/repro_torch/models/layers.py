"""Shared neural building blocks (port of ``repro.models.layers``).

Parameters are plain dicts of tensors with the reference's names and
layouts (``{"w": (d_in, d_out), "b": (d_out,)}``), so a JAX parameter
tree carries across as numpy arrays.  Init draws from an explicit
``torch.Generator``, on the generator's device; the numbers differ from
``jax.random``'s, so parity tests carry the reference's weights across.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor of a params tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def from_numpy(a, device) -> torch.Tensor:
    """A (possibly read-only) numpy array as a tensor on ``device``.  A
    bfloat16 array (``ml_dtypes.bfloat16``, which numpy has no name for)
    crosses as its 16-bit patterns: the same bits, not a rounded copy."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal f32 of ``shape`` on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: Optional[float] = None) -> Params:
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    p = {"w": normal(gen, (d_in, d_out)) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x @ w (+ b)`` in ``dtype``: bf16 by default, as the reference,
    which casts input and f32 weight on every call."""
    y = x.to(dtype) @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def rmsnorm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def mlp_init(gen: torch.Generator, d: int, d_ff: int,
             mlp_type: str) -> Params:
    if mlp_type == "swiglu":
        return {"wi": dense_init(gen, d, d_ff),
                "wg": dense_init(gen, d, d_ff),
                "wo": dense_init(gen, d_ff, d, scale=1.0 / np.sqrt(d_ff))}
    return {"wi": dense_init(gen, d, d_ff),
            "wo": dense_init(gen, d_ff, d, scale=1.0 / np.sqrt(d_ff))}


def mlp(p: Params, x: torch.Tensor, mlp_type: str,
        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if mlp_type == "swiglu":
        h = F.silu(dense(p["wg"], x, dtype)) * dense(p["wi"], x, dtype)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(dense(p["wi"], x, dtype), approximate="tanh")
    return dense(p["wo"], h, dtype)


# --- rotary ---------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)            # (hd/2,)
    ang = positions[..., :, None].float() * freqs      # (..,S,hd/2)
    cos = torch.cos(ang)[..., :, None, :]              # (..,S,1,hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)
