"""Flash attention (forward): online-softmax attention over KV tiles.

Port of ``repro.kernels.flash_attention``.  On a CUDA tensor the
wrapper launches ``csrc/flash_attention.cu`` (f32 on the CUDA cores,
bf16 on the tensor cores; any S); on a CPU tensor it runs
:func:`flash_attention_plain`.  The layout is the reference's: q and k
(BH, S, dqk), v (BH, S, dv), the output (BH, S, dv) in q's dtype, the
scale 1/sqrt(dqk).  The kernels take (dqk, dv) of (64, 64) and
(128, 128), and the bf16 kernel also MLA's (96, 64) (MiniCPM3: 64 nope +
32 rope, v 64).  The kernel picks its own tiles,
so there are no ``blk_*`` arguments, and sizes its own shared memory: a
refused opt-in comes back as the launch's error code and raises.

The bf16 kernel rounds P to bf16 before P V (as the JAX model's own
attention does); the plain version keeps P in f32, as the Pallas
kernel.  :func:`bf16_bound` is how far apart the two may be.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: "flash_attention_f32",
           torch.bfloat16: "flash_attention_bf16"}
# (dqk, dv) of each dtype's instantiations in csrc/flash_attention.cu
_HEAD_DIMS = {torch.float32: ((64, 64), (128, 128)),
              torch.bfloat16: ((64, 64), (128, 128), (96, 64))}
# the bf16 kernel's TMA descriptors need 16-byte-aligned tensors
_TMA_ALIGN = 16


def _probs(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """The f32 masked softmax of q k^T / sqrt(dqk): (BH, S, S)."""
    s = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask[None], logits, NEG_INF)
    return torch.softmax(logits, dim=-1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """A full f32 masked softmax (``repro.kernels.ref.flash_attention_ref``
    in torch): q, k (BH, S, dqk), v (BH, S, dv) -> (BH, S, dv) in q's
    dtype."""
    p = _probs(q, k, causal)
    return torch.einsum("bqk,bkh->bqh", p, v.float()).to(q.dtype)


def bf16_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               want: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """Per-element bound on |bf16 kernel - ``want``|, ``want`` being
    :func:`flash_attention_plain` of the same bf16 inputs:
    2^-7 (P |V|) + 2^-7 |want| + 1e-5, P the plain version's f32
    softmax.  Rounding each P entry to bf16 moves each term p_i v_i by at
    most 2^-8 of itself, counted twice for the running sum l; the two
    outputs are each rounded once to bf16, so at most one ulp (2^-7 of
    the value) apart; 1e-5 covers f32 summation order near 0."""
    pv = torch.einsum("bqk,bkh->bqh", _probs(q, k, causal), v.float().abs())
    return 2.0 ** -7 * pv + 2.0 ** -7 * want.float().abs() + 1e-5


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q, k (BH, S, dqk), v (BH, S, dv), f32 or bf16, one dtype ->
    (BH, S, dv)."""
    bh, s, dqk = q.shape
    dv = v.shape[-1]
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    dev = _build.check_inputs("flash_attention", q=(q, q.dtype, (bh, s, dqk)),
                              k=(k, q.dtype, (bh, s, dqk)),
                              v=(v, q.dtype, (bh, s, dv)))
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if (dqk, dv) not in _HEAD_DIMS[q.dtype]:
        raise ValueError(f"flash_attention: the {q.dtype} kernel takes "
                         f"(dqk, dv) in {_HEAD_DIMS[q.dtype]}, got "
                         f"{(dqk, dv)}")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % _TMA_ALIGN for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k and v must start "
                         f"{_TMA_ALIGN}-byte aligned")
    out = torch.empty((bh, s, dv), dtype=q.dtype, device=dev)
    if bh and s:
        _build.launch(_DTYPES[q.dtype], dev, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), bh, s, dqk, dv,
                      int(causal))
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
