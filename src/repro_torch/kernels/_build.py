"""Build and load the CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), linked into one shared
library with a plain C interface and loaded with ``ctypes``.  The
library lands in the package's ``build/`` directory (git-ignored),
named by a hash of the sources and flags, so a tree builds once per
source change.  Nothing here runs at import: the first kernel launch
calls :func:`library`.  The wrappers' input checks and the launch
itself (stream, error check) live here too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: every pointer and the stream are void*, sizes are int;
# each returns cudaGetLastError() of its launch.
_SIGNATURES = {
    "ivf_scan": [_P] * 4 + [_I] * 4 + [_P],
    "topk_merge": [_P] * 6 + [_I] * 5 + [_P],
    "ivf_scan_merge": [_P] * 14 + [_I] * 8 + [_P],
    "delta_scan": [_P] * 3 + [_I] * 3 + [_P],
    "flash_attention_f32": [_P] * 4 + [_I] * 4 + [_P],
    "flash_attention_bf16": [_P] * 4 + [_I] * 4 + [_P],
    "embedding_bag": [_P] * 3 + [_I] * 3 + [_P],
    "launch_floor": [_P],   # an empty kernel: no call takes less time
}
# C entry points that launch nothing (no stream, an int result)
_QUERIES = {"max_shared_optin": [_I]}
# a block's dynamic shared memory needs no opt-in up to this size
DEFAULT_SMEM = 48 * 1024

_lib: Optional[ctypes.CDLL] = None
_smem_optin = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in (shutil.which("nvcc"),
                 CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/`` into ``build/librepro_torch_<hash>.so`` unless
    that file exists; returns its path.  ``verbose`` prints what
    ``ptxas -v`` reports for each kernel (registers, spills)."""
    sources = sorted(CSRC.glob("*.cu"))
    so = BUILD / f"librepro_torch_{_digest(sorted(CSRC.glob('*.cu*')))}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        extra = ["-Xptxas", "-v"] if verbose else []
        objs, procs = [], []
        for src in sources:
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *FLAGS, *extra, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            if verbose and out:
                print(f"[nvcc {src.name}]\n{out}")
            if p.returncode:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *ARCH, "-shared", *objs, "-o", tmp_so],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(tmp_so, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in {**_SIGNATURES, **_QUERIES}.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, dev, *args) -> None:
    """Call C entry point ``name`` with ``args`` and the current stream of
    CUDA device ``dev``; raise if its ``cudaGetLastError`` is not 0 (a
    refused launch never runs, and no later synchronise reports it)."""
    import torch
    with torch.cuda.device(dev):
        rc = getattr(library(), name)(
            *args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with error {rc}")


def max_shared_optin(dev) -> int:
    """The most dynamic shared memory a block may opt in to on CUDA
    device ``dev`` (232,448 bytes on an H100)."""
    index = dev.index if dev.index is not None else 0
    if index not in _smem_optin:
        v = library().max_shared_optin(index)
        if v <= 0:
            raise RuntimeError(f"cannot read the shared memory limit of "
                               f"cuda:{index}")
        _smem_optin[index] = v
    return _smem_optin[index]


def check_smem(name: str, dev, n_bytes: int, shape: str) -> None:
    """Raise unless ``n_bytes`` of dynamic shared memory (past 48 KB, by
    the kernel's opt-in) fit one block on ``dev``; ``shape`` names the
    arguments that sized it."""
    if n_bytes <= DEFAULT_SMEM:
        return
    limit = max_shared_optin(dev)
    if n_bytes > limit:
        raise ValueError(f"{name}: {shape} need {n_bytes} bytes of shared "
                         f"memory per block; the card allows {limit}")


def check_inputs(name: str, **specs):
    """Validate a kernel's inputs before pointers are taken.

    Each spec is ``(tensor, dtype, shape)``, a ``None`` in ``shape``
    matching any size.  Every tensor must have its dtype and shape, be
    contiguous, and lie on one device, which is returned.
    """
    devices = {t.device for t, _, _ in specs.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs lie on different devices "
                         f"{sorted(map(str, devices))}")
    for arg, (t, dtype, shape) in specs.items():
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if len(shape) != t.dim() or any(
                want is not None and want != got
                for want, got in zip(shape, t.shape)):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev
