"""Shared benchmark substrate (port of ``benchmarks.common``): three
synthetic 'encoders' standing in for STAR / Contriever / TAS-B.  Harder
encoders (larger spread) need larger N for R*@1 >= 0.95, mirroring the
paper's N = 80 / 140 / 190 progression.

Each corpus is seeded from a stable digest of the encoder's name
(``zlib.crc32``; the reference's ``hash`` is salted per process), and
cached on disk as ``.npz`` files of their own, named with that seed.
The index is built anew on the device at every load.
"""
from __future__ import annotations

import os
import subprocess
import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import brute_force, build_index
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.training import choose_n_probe
from repro_torch.data.synthetic import Corpus, clustered_corpus

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts")
CACHE = os.path.join(ARTIFACTS, "bench_cache")

# name -> (spread, hard_frac): harder encoder == more dispersed clusters
ENCODERS = {
    "star-like": (0.22, 0.25),
    "contriever-like": (0.32, 0.35),
    "tasb-like": (0.40, 0.45),
}

N_DOCS = 60_000
DIM = 64
N_COMPONENTS = 512
N_QUERIES = 3072
K = 50
TAU = 5
RHO = 0.95


# smoke mode: a few-seconds substrate — same pipeline shape, fraction of
# the data
SMOKE_N_DOCS = 4000
SMOKE_DIM = 24
SMOKE_N_COMPONENTS = 64
SMOKE_N_QUERIES = 384


@dataclass
class Bench:
    name: str
    corpus: Corpus
    index: IVFIndex
    n_probe: int
    exact_ids: np.ndarray      # (nq, K)
    splits: Dict[str, slice]


def _sizes(smoke: bool) -> Tuple[int, int, int, int]:
    if smoke:
        return SMOKE_N_DOCS, SMOKE_DIM, SMOKE_N_COMPONENTS, SMOKE_N_QUERIES
    return N_DOCS, DIM, N_COMPONENTS, N_QUERIES


def encoder_seed(name: str) -> int:
    """The corpus seed of an encoder: the same in every process."""
    return zlib.crc32(name.encode()) % 2 ** 31


def exact_top_k(docs: np.ndarray, queries: np.ndarray, k: int,
                dev: torch.device, block: int = 512) -> np.ndarray:
    """(nq, k) exact neighbour ids, by the port's ``brute_force``."""
    docs_t = torch.as_tensor(docs, device=dev)
    out = np.empty((queries.shape[0], k), np.int32)
    for s in range(0, queries.shape[0], block):
        q = torch.as_tensor(queries[s: s + block], device=dev)
        out[s: s + block] = brute_force(docs_t, q, k)[1].cpu().numpy()
    return out


def bench_from_corpus(name: str, corpus: Corpus, n_components: int, *,
                      smoke: bool = False, device: DeviceLike = None,
                      n_probe: Optional[int] = None,
                      exact_ids: Optional[np.ndarray] = None) -> Bench:
    """A :class:`Bench` over ``corpus``: the index built on ``device``
    (CUDA unless ``device="cpu"``), N chosen on the valid split and the
    exact top-K, unless given."""
    dev = resolve_device(device)
    index = build_index(corpus.docs, n_components, list_pad=256, n_iters=6,
                        seed=0, device=dev)
    nq = corpus.queries.shape[0]
    sp = _splits(nq, smoke)
    if n_probe is None:
        n_probe = choose_n_probe(index, corpus.docs,
                                 corpus.queries[sp["valid"]], rho=RHO, k=K,
                                 n_max=n_components)
    if exact_ids is None:
        exact_ids = exact_top_k(corpus.docs, corpus.queries, K, dev)
    return Bench(name, corpus, index, n_probe, exact_ids, sp)


def load_bench(name: str, *, force: bool = False, smoke: bool = False,
               device: DeviceLike = None) -> Bench:
    """The encoder's substrate on ``device`` (CUDA unless
    ``device="cpu"``), from the cache unless ``force``."""
    device = resolve_device(device)
    n_docs, dim, comps, nq = _sizes(smoke)
    seed = encoder_seed(name)
    path = os.path.join(CACHE, f"{name}_torch_{seed}"
                        f"{'_smoke' if smoke else ''}.npz")
    if os.path.exists(path) and not force:
        with np.load(path) as saved:
            corpus = Corpus(saved["docs"], saved["queries"],
                            saved["relevant"])
            return bench_from_corpus(name, corpus, comps, smoke=smoke,
                                     device=device,
                                     n_probe=int(saved["n_probe"]),
                                     exact_ids=saved["exact_ids"])
    spread, hard = ENCODERS[name]
    corpus = clustered_corpus(n_docs=n_docs, dim=dim, n_components=comps,
                              n_queries=nq, spread=spread, hard_frac=hard,
                              seed=seed)
    b = bench_from_corpus(name, corpus, comps, smoke=smoke, device=device)
    os.makedirs(CACHE, exist_ok=True)
    np.savez(path, docs=corpus.docs, queries=corpus.queries,
             relevant=corpus.relevant, n_probe=b.n_probe,
             exact_ids=b.exact_ids)
    return b


def _splits(nq: int = N_QUERIES, smoke: bool = False) -> Dict[str, slice]:
    n_test = 128 if smoke else 1024
    n_valid = 64 if smoke else 512
    return {"train": slice(0, nq - n_test - n_valid),
            "valid": slice(nq - n_test - n_valid, nq - n_test),
            "test": slice(nq - n_test, nq)}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_info(dev: torch.device) -> Dict:
    """The backend and device a benchmark ran on: on the card its name
    and power limit (``nvidia-smi``), on the CPU the host's processor."""
    if dev.type != "cuda":
        import platform
        return {"backend": "cpu", "device": platform.processor() or "cpu",
                "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    line = out.strip().splitlines()[dev.index or 0]
    return {"backend": "cuda", "device": torch.cuda.get_device_name(dev),
            "power_limit": line.split(",")[-1].strip()}
