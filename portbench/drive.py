"""The one traffic generator: it reads a traffic mix's
parameters and drives the program's serving entry with them.

A mix's ``loop`` is ``closed``: back-to-back ``serve()`` calls of
``call_queries`` queries each, drawn in order from a query pool of
``pool`` queries, until the window's seconds have passed; the last call
is counted whole.  An open loop (arrivals at a fixed rate, latency from
the due time) is left for the cell that needs it (PERF.md).

A mix may also carry a ``mutations`` block (``adds_per_wave``,
``deletes_per_wave``, ``plants_per_wave`` and their ``source``): it
makes a live cell, whose configuration has a ``live`` block
(``delta_cap``, ``merge_every``).  The harness then serves the
program's live index and hands the load the mutation stream
(``mutations.Stream``); the ``serve`` it is given passes the stream to
the program as its ``on_wave`` hook, which writes to the index after
every wave.  Each call then carries the stream's record of it
(``Call.mutations``: its first wave, waves, plants, adds, deletes,
merges and forced merges, and host ms in the hook and in
``merge_delta``).  The check holds a live run to what the stream
published: no answer holds an id deleted before its last probe's wave,
every query admitted after its plant was published holds the plant
while it lives, and the waves of each call are those the scheduler's
admission rule gives for its probe counts (``judge.py``).

Reports are kept as they come; nothing is read from them inside the
window.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class Call:
    t_send: float                 # host clock at the serve() call
    t_done: float                 # host clock at its return
    pool_idx: np.ndarray          # (nq,) int64 pool rows served
    report: object                # the program's ServeReport
    mutations: Optional[dict] = None   # the stream's record of the call


@dataclasses.dataclass
class Window:
    t0: float
    t1: float
    calls: List[Call]

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Load:
    """Drives ``serve(pool_rows) -> report`` with one traffic mix.  The
    pool position carries over from window to window.  With a
    ``stream`` (a live cell), each call begins a record of it there."""

    def __init__(self, traffic: dict, pool_size: int,
                 serve: Callable, sync: Callable[[], None], stream=None):
        if traffic["loop"] != "closed":
            raise ValueError(f"unknown loop {traffic['loop']!r}")
        self.traffic = traffic
        self.pool_size = pool_size
        self.serve = serve
        self.sync = sync
        self.stream = stream
        self.next_q = 0

    def _take(self, n: int) -> np.ndarray:
        idx = (self.next_q + np.arange(n)) % self.pool_size
        self.next_q = (self.next_q + n) % self.pool_size
        return idx

    def _call(self, idx: np.ndarray) -> Call:
        rec = None if self.stream is None else self.stream.begin_call()
        t_send = time.perf_counter()
        rep = self.serve(idx)
        self.sync()
        return Call(t_send, time.perf_counter(), idx, rep, rec)

    def window(self, seconds: float) -> Window:
        n = self.traffic["call_queries"]
        calls = []
        self.sync()
        t0 = time.perf_counter()
        while not calls or calls[-1].t_done - t0 < seconds:
            calls.append(self._call(self._take(n)))
        return Window(t0, calls[-1].t_done, calls)

    def warmup(self) -> None:
        """One call of each size the mix's ``warmup`` lists."""
        for n in self.traffic["warmup"]:
            self._call(self._take(n))
        self.next_q = 0
