"""The mutation stream of a live cell: the ``on_wave`` hook that writes
to the program's live index between waves.

A mix with a ``mutations`` block serves a configuration with a ``live``
block through the program's ``LiveIndex`` and ``IndexRegistry``.  After
every wave of every ``serve()`` call (waves are counted over the whole
run, warm-up included) the stream, in order:

1. plants ``plants_per_wave`` copies of pool queries drawn uniformly,
   each plus noise of norm ``PLANT_NOISE``, normalised: each is its
   query's top-1 document from then on;
2. adds ``adds_per_wave`` vectors by the corpus's own recipe: a list's
   centre, the list drawn uniformly, plus that list's noise, normalised
   (plants and adds in one ``LiveIndex.add``);
3. deletes ``deletes_per_wave`` ids drawn uniformly from the live ids,
   base and added alike;
4. merges the delta buffer every ``merge_every`` waves of the config's
   ``live`` block (0: never); a full buffer (``DeltaFull``) is answered
   by a merge, counted as forced;
5. publishes ``version_of(live)`` to the registry, which the scheduler
   adopts at the top of the next wave.

The vectors come from a generator on the device seeded by the run's
seed and the wave, the deletes from one on the host seeded alike.  The
log keeps only ids, the seeds and the waves of merges; the check
regenerates the vectors from it (:func:`overlay`).  Of the program the
stream calls ``LiveIndex.add``, ``delete`` and ``merge_delta``,
``IndexRegistry.publish`` and ``version_of``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .reference import ivf_live

# norm of the noise a planted copy of a query carries
PLANT_NOISE = 1e-3
# whatever the stream records of one serve() call
RECORD_KEYS = ("plants", "adds", "deletes", "merges", "forced_merges",
               "hook_ms", "merge_ms")


def wave_seed(seed: int, wave: int) -> int:
    """The seed of one wave's draws, from the run's seed and the wave."""
    return int(np.random.SeedSequence([seed % 2 ** 64, wave])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def draw(g: torch.Generator, centroids, scale, pool, plants: int,
         adds: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One wave's vectors: (plants + adds, d) f32 unit rows, the plants
    first, and (plants,) the pool rows they copy."""
    dev = centroids.device
    d = centroids.shape[1]
    rows = torch.randint(pool.shape[0], (plants,), generator=g, device=dev)
    e = torch.randn(plants, d, generator=g, device=dev)
    e *= PLANT_NOISE / e.norm(dim=1, keepdim=True)
    lists = torch.randint(centroids.shape[0], (adds,), generator=g,
                          device=dev)
    x = torch.randn(adds, d, generator=g, device=dev)
    x.mul_(scale[lists, None]).add_(centroids[lists])
    out = torch.cat([pool[rows] + e, x])
    out /= out.norm(dim=1, keepdim=True)
    return out, rows


@dataclasses.dataclass
class Log:
    """What the stream did, in ids and waves only: wave ``g`` (1-based)
    is entry ``g - 1`` of each list."""
    seed: int
    n_base: int
    plants: int                   # plants a wave, then adds
    adds: int
    first_id: List[int] = dataclasses.field(default_factory=list)
    deleted: List[np.ndarray] = dataclasses.field(default_factory=list)
    merges: List[int] = dataclasses.field(default_factory=list)
    forced: List[int] = dataclasses.field(default_factory=list)

    @property
    def waves(self) -> int:
        return len(self.first_id)


class Stream:
    """The ``on_wave`` hook over one live index and its registry."""

    def __init__(self, live, registry, version_of, corpus, cfg: dict,
                 mix: dict, seed: int):
        from repro_torch.index.delta import DeltaFull
        self._full = DeltaFull
        self.live, self.registry, self.version_of = live, registry, \
            version_of
        m = mix["mutations"]
        self.n_plants, self.n_adds = m["plants_per_wave"], m["adds_per_wave"]
        self.n_deletes = m["deletes_per_wave"]
        self.merge_every = cfg["live"]["merge_every"]
        self.centroids, self.scale, self.pool = (corpus.centroids,
                                                 corpus.scale, corpus.pool)
        n = corpus.n_docs
        self.log = Log(seed, n, self.n_plants, self.n_adds)
        self.wave = 0                              # over the whole run
        self._g = torch.Generator(device=corpus.pool.device)
        # the live ids, and each id's place among them (-1: gone)
        self._ids = np.arange(n, dtype=np.int64)
        self._at = np.arange(n, dtype=np.int64)
        self._n_live = n
        self._added = 0
        self.calls: List[Dict[str, float]] = []
        self._rec: Optional[Dict[str, float]] = None

    def begin_call(self) -> Dict[str, float]:
        """Start the record of one ``serve()`` call: its first wave is
        ``first_wave + 1``."""
        self._rec = dict(first_wave=self.wave, waves=0,
                         **{key: 0 for key in RECORD_KEYS})
        self.calls.append(self._rec)
        return self._rec

    def merges(self) -> int:
        return len(self.log.merges) + len(self.log.forced)

    def _merge(self, forced: bool) -> None:
        t = time.perf_counter()
        self.live.merge_delta()
        self._rec["merge_ms"] += 1e3 * (time.perf_counter() - t)
        self._rec["forced_merges" if forced else "merges"] += 1
        (self.log.forced if forced else self.log.merges).append(self.wave)

    def _grow(self, n: int) -> None:
        if n > self._at.shape[0]:
            cap = max(n, 2 * self._at.shape[0])
            self._at = np.concatenate(
                [self._at, np.full(cap - self._at.shape[0], -1, np.int64)])
            self._ids = np.concatenate(
                [self._ids, np.zeros(cap - self._ids.shape[0], np.int64)])

    def _pick_deletes(self, rng: np.random.Generator) -> np.ndarray:
        """Ids drawn uniformly from the live ones, without repeats."""
        n = min(self.n_deletes, self._n_live)
        out = np.empty(n, np.int64)
        for i, u in enumerate(rng.random(n)):
            j = int(u * self._n_live)
            out[i] = victim = self._ids[j]
            self._n_live -= 1
            last = self._ids[self._n_live]
            self._ids[j], self._at[last] = last, j
            self._at[victim] = -1
        return out

    def __call__(self, wave_of_call: int) -> None:
        t = time.perf_counter()
        self.wave += 1
        rec = self._rec
        rec["waves"] += 1
        s = wave_seed(self.log.seed, self.wave)
        self._g.manual_seed(s)
        m = self.n_plants + self.n_adds
        first = -1
        if m:
            vecs, _ = draw(self._g, self.centroids, self.scale, self.pool,
                           self.n_plants, self.n_adds)
            try:
                ids = self.live.add(vecs)
            except self._full:
                self._merge(forced=True)
                ids = self.live.add(vecs)
            first = self.log.n_base + self._added
            if not np.array_equal(ids, np.arange(first, first + m)):
                raise RuntimeError(f"wave {self.wave}: the live index gave "
                                   f"ids {ids[:4]}..., not {first}.. in "
                                   f"order")
            self._added += m
            self._grow(first + m)
            self._ids[self._n_live:self._n_live + m] = ids
            self._at[ids] = np.arange(self._n_live, self._n_live + m)
            self._n_live += m
        self.log.first_id.append(first)
        gone = self._pick_deletes(np.random.default_rng(s))
        if gone.size:
            self.live.delete(gone)
        self.log.deleted.append(gone)
        if self.merge_every and self.wave % self.merge_every == 0:
            self._merge(forced=False)
        self.registry.publish(self.version_of(self.live))
        rec["plants"] += self.n_plants
        rec["adds"] += self.n_adds
        rec["deletes"] += gone.size
        rec["hook_ms"] += 1e3 * (time.perf_counter() - t)

    def release(self) -> None:
        """Drop the program's objects (the check runs without them)."""
        self.live = self.registry = self.version_of = None


def overlay(log: Log, centroids, scale, pool
            ) -> Tuple[ivf_live.Overlay, torch.Tensor, torch.Tensor]:
    """The run's mutations regenerated from its log: the reference's
    overlay, and each plant's (P,) id and (P,) pool row."""
    dev = centroids.device
    g = torch.Generator(device=dev)
    m = log.plants + log.adds
    vecs, add_wave, plant_id, plant_row = [], [], [], []
    for i, first in enumerate(log.first_id):
        if first < 0:
            continue
        g.manual_seed(wave_seed(log.seed, i + 1))
        v, rows = draw(g, centroids, scale, pool, log.plants, log.adds)
        vecs.append(v)
        plant_row.append(rows)
        plant_id.append(torch.arange(first, first + log.plants, device=dev))
        add_wave.append(torch.full((m,), i + 1, dtype=torch.int64,
                                   device=dev))
    d = centroids.shape[1]
    vecs = torch.cat(vecs) if vecs else torch.zeros(0, d, device=dev)
    deleted = torch.full((log.n_base + vecs.shape[0],), ivf_live.NEVER,
                         dtype=torch.int64, device=dev)
    gone = np.concatenate([np.zeros(0, np.int64), *log.deleted])
    when = np.repeat(np.arange(1, log.waves + 1),
                     [x.size for x in log.deleted])
    deleted[torch.as_tensor(gone, device=dev)] = torch.as_tensor(
        when, device=dev)
    cat = (lambda xs, dt: torch.cat(xs) if xs
           else torch.zeros(0, dtype=dt, device=dev))
    return (ivf_live.Overlay(vecs, cat(add_wave, torch.int64), deleted,
                             log.n_base),
            cat(plant_id, torch.int64), cat(plant_row, torch.int64))
