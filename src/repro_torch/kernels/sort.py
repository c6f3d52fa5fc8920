"""Packed (score, id) records: the plain PyTorch counterpart of
``repro.kernels.sort`` on ``int32`` tensors.

Scores map to int32 *keys* (``score_to_key``) whose signed order is the
float order; the map is an exact involution (``key_to_score``).  A
record is (key, id word); records sort descending by key, then by the
id word, so exact-score ties go to the *higher* id word — compared
while it still carries ``NEW_MARK``.  ``NEW_MARK`` (bit 30) flags ids
that entered on the current probe; the empty/tombstone id ``-1`` is
never marked.

The CUDA side of these rules is ``csrc/packed_sort.cuh``; the three
merging kernels share it, and ``row_topk`` its key map and words.  The
plain sort here packs each record into one int64, ``(key << 32) |
(idw + 2**31)``: the bias keeps ``-1`` below every real id in the low
word.  Records are totally ordered and equal
records are identical, so any correct sort — this one or the bitonic
network of the kernels — gives the same output bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

_SIGN_FLIP = 0x7FFFFFFF          # flips magnitude bits of negatives
NEW_MARK = 1 << 30               # id-word bit: entered on this probe
_BIAS = 1 << 31


def score_to_key(s: torch.Tensor) -> torch.Tensor:
    """f32 -> i32, strictly order-preserving under signed compare."""
    bits = s.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ _SIGN_FLIP, bits)


def key_to_score(key: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`score_to_key` (it is an involution)."""
    bits = torch.where(key < 0, key ^ _SIGN_FLIP, key)
    return bits.contiguous().view(torch.float32)


def key_of(x: float) -> int:
    """Host-side key of a python float (for sentinel constants)."""
    b = int(np.float32(x).view(np.int32))
    return b ^ _SIGN_FLIP if b < 0 else b


def mark_new(ids: torch.Tensor) -> torch.Tensor:
    """Set the new-entry bit on real ids; -1 sentinels pass through."""
    return torch.where(ids >= 0, ids | NEW_MARK, ids)


def strip_marks(idw: torch.Tensor) -> torch.Tensor:
    """Clear the mark bit.  Guarded on sign so ``-1`` stays ``-1``."""
    return torch.where(idw >= 0, idw & ~NEW_MARK, idw)


def is_marked(idw: torch.Tensor) -> torch.Tensor:
    return (idw >= 0) & ((idw & NEW_MARK) != 0)


def pack(keys: torch.Tensor, idw: torch.Tensor) -> torch.Tensor:
    """Stack (R, M) key / id-word lanes into the (R, 2, M) sort form."""
    return torch.stack([keys, idw], dim=1)


def bitonic_desc_packed(x: torch.Tensor) -> torch.Tensor:
    """Sort a packed (R, 2, M) int32 array descending by (key, id word).

    Same contract (and, records being totally ordered, the same output)
    as the reference's bitonic network; M must be a power of two.
    """
    r, two, m = x.shape
    if two != 2 or m & (m - 1):
        raise ValueError(f"expected (R, 2, power-of-two M), got {x.shape}")
    word = (x[:, 0].to(torch.int64) << 32) | (x[:, 1].to(torch.int64)
                                              + _BIAS)
    word = torch.sort(word, dim=1, descending=True).values
    keys = (word >> 32).to(torch.int32)
    idw = ((word & 0xFFFFFFFF) - _BIAS).to(torch.int32)
    return pack(keys, idw)


def merge_packed(run: torch.Tensor, new_keys: torch.Tensor,
                 new_idw: torch.Tensor, m_pad: int, *,
                 pad_key: int) -> torch.Tensor:
    """Merge a packed running (R, 2, K) state with (R, M) candidates.

    Pads the concatenation to ``m_pad`` lanes with (pad_key, -1) and
    returns the full sorted (R, 2, m_pad) output; callers slice the
    leading K lanes back into their running state.
    """
    ck = torch.cat([run[:, 0], new_keys], dim=1)
    ci = torch.cat([run[:, 1], new_idw], dim=1)
    pad = m_pad - ck.shape[1]
    if pad:
        ck = torch.nn.functional.pad(ck, (0, pad), value=pad_key)
        ci = torch.nn.functional.pad(ci, (0, pad), value=-1)
    return bitonic_desc_packed(pack(ck, ci))


def next_pow2(n: int) -> int:
    """Network width for ``n`` records (the reference's ``m_pad``)."""
    return 1 << int(np.ceil(np.log2(n)))
