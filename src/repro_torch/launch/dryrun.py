"""Multi-pod dry run (port of ``repro.launch.dryrun``): run rank 0's
program of every (arch × shape) cell on the production mesh and dump
its memory, cost and collective record.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \
        --shape train_4k --mesh single --out artifacts/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

No card and no allocation: a ``"fake"`` process group of the mesh's
size (256, or 512 for two pods) stands in for the cluster, rank 0's
program runs on ``meta`` tensors (``launch.cells``), and
``launch.cost_analysis`` counts it.  The group is torn down after each
cell, so nothing leaks into a later ``torch.distributed`` user of the
process.  A cell that fails records ``status: "fail"`` with its error,
and the run goes on.  The records feed ``repro_torch.benchmarks.roofline``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
import traceback
from typing import Dict, Optional, Sequence

OUT = os.path.join("artifacts", "dryrun_torch")


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks, this process
    rank 0: collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def quiet_dtensor():
    """``DTensor``'s advice on sequential collectives, logged once per
    redistribution, off while a cell runs."""
    names = ("torch.distributed.tensor", "torch._logging._internal")
    loggers = [logging.getLogger(n) for n in names]
    levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.setLevel(logging.ERROR)
    try:
        yield
    finally:
        for lg, lv in zip(loggers, levels):
            lg.setLevel(lv)


def measure(cell):
    """Run ``cell``'s program once under a cost counter: (counter,
    outputs)."""
    from repro_torch.launch import cells as cells_lib
    from repro_torch.launch.cost_analysis import CostCounter, _tensors

    counter = CostCounter(_tensors(cell.args))
    with cells_lib.program(), counter:
        out = cell.fn(*cell.args)
    return counter, _tensors(out)


def record(spec, shape: str, mesh_shape: Sequence[int],
           names: Sequence[str], *, skip_cost: bool = False) -> Dict:
    """The dry-run record of ``spec`` (an ``ArchSpec``) at ``shape`` on a
    mesh of ``mesh_shape`` named ``names``, built and counted under a
    fake group of its size (torn down before this returns)."""
    import math

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import cells as cells_lib

    n_dev = math.prod(mesh_shape)
    t0 = time.time()
    rec: Dict = {"arch": spec.arch_id, "shape": shape,
                 "mesh": "multi" if "pod" in names else "single",
                 "n_devices": n_dev, "status": "ok"}
    try:
        with fake_group(n_dev), quiet_dtensor():
            mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                    mesh_dim_names=tuple(names))
            cell = cells_lib.build_cell(spec.arch_id, shape, mesh,
                                        spec=spec)
            counter, outs = measure(cell)
            rec["memory"] = counter.memory(outs)
            rec["note"] = cell.note
            rec["model_flops_global"] = cell.model_flops
            if not skip_cost:
                rec["cost"] = counter.cost()
                rec["collectives"] = counter.collectives.to_dict()
                rec["cost_method"] = "direct"
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["compile_s"] = round(time.time() - t0, 1)
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str = OUT,
             *, skip_cost: bool = False) -> Dict:
    """``arch``'s cell ``shape`` on the production mesh (one pod, or two
    with ``multi_pod``); the record is written to ``out_dir`` too."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.mesh import production_mesh_shape

    shape_, names = production_mesh_shape(multi_pod)
    rec = record(get_arch(arch), shape, shape_, names, skip_cost=skip_cost)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape}__{rec['mesh']}".replace("/", "_")
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--skip-cost", action="store_true",
                    help="memory only (no cost or collective record)")
    args = ap.parse_args(argv)

    from repro_torch.launch import cells as cells_lib
    todo = cells_lib.all_cells() if args.all else [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_fail = 0
    for arch, shape in todo:
        for mp in meshes:
            rec = run_cell(arch, shape, mp, args.out,
                           skip_cost=args.skip_cost)
            mark = "OK " if rec["status"] == "ok" else "FAIL"
            extra = "" if rec["status"] == "ok" else \
                " :: " + rec.get("error", "")[:160]
            peak = rec.get("memory", {}).get("peak_gb", float("nan"))
            print(f"[{mark}] {arch:22s} {shape:18s} "
                  f"{rec['mesh']:6s} peak={peak:8.2f}GB "
                  f"t={rec['compile_s']:6.1f}s{extra}", flush=True)
            n_fail += rec["status"] != "ok"
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
