"""PyTorch/CUDA port of the early-exit A-kNN system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core/``, ``index/``, ``kernels/``, ``data/``, ``launch/``,
``configs/``, ``models/``) and runs on an NVIDIA Hopper card through
hand-written CUDA kernels (``csrc/*.cu``, built by ``kernels/_build.py``
at first use).

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

# The reference scores in full f32: TF32 products would move near-ties.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise.  Raises when CUDA is asked for (or implied) but absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available")
    return dev
