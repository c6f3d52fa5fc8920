"""``BENCHMARK.json`` as the harness reads it, and the files it names.

Everything that belongs to one configuration, traffic mix or metric is
a file of its own, found by name:

- a configuration: the ``file`` its entry in ``BENCHMARK.json`` gives
  (``portbench/configs/<config>.json``);
- a traffic mix: ``portbench/traffic/<traffic>.json``;
- a metric: ``portbench/metrics/<metric>.py``, which defines
  ``read(run) -> float | None``.

So a later cell, mix or metric is added as files and entries, and no
file here changes.

A configuration may carry a ``live`` block (``delta_cap``, and
``merge_every`` waves, 0 for no scheduled merge) and a mix a
``mutations`` block (``adds_per_wave``, ``deletes_per_wave``,
``plants_per_wave`` and a ``source``): a cell of such a mix on such a
configuration is live (``mutations.py``).

A configuration may instead carry a ``policy`` block: its exit is the
paper's cascade, a classifier at ``tau`` probes before the patience
exit, whose trees the benchmark trains at set-up (``policy.py``) and
``reference/ivf_cascade.py`` judges.  A configuration names the
reference that judges it under ``"reference"``: the cascade one with a
policy, the live one with a live block, else the patience one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, List, Optional

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
MUTATION_COUNTS = ("adds_per_wave", "deletes_per_wave", "plants_per_wave")
# the numbers a live configuration's check holds at limit 0
LIVE_LIMITS = ("deleted_returned", "acked_add_missed", "schedule_mismatch")
POLICY_KINDS = ("cascade_patience",)
TRAIN_COUNTS = ("queries", "valid", "n_trees", "max_depth", "n_bins")
REFERENCES = {"policy": "portbench/reference/ivf_cascade.py",
              "live": "portbench/reference/ivf_live.py",
              None: "portbench/reference/ivf_patience.py"}


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix file's contents
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read."""
    bench = load_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name,
        config=load_json(root / cfg_entry["file"]),
        traffic=load_json(root / "portbench" / "traffic"
                          / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)])


def reader(root: Path, metric: str) -> Callable[[object], Optional[float]]:
    """``read`` of ``portbench/metrics/<metric>.py`` (a name may hold
    dots, so the file is loaded by its path)."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _count(x, least: int = 0) -> bool:
    return isinstance(x, int) and not isinstance(x, bool) and x >= least


def live_problems(name: str, cfg: dict, mix: dict) -> List[str]:
    """What breaks the rules of a live cell ``name``: a mix with
    ``mutations`` on a configuration without a ``live`` block, a live
    configuration under a mix without them, a count that is no whole
    number or is negative, and a live configuration whose check has no
    limit 0 on the numbers that hold a live run to its stream."""
    out = []
    muts, live = mix.get("mutations"), cfg.get("live")
    if muts is not None and live is None:
        out.append(f"{name}: mix with mutations on config {cfg.get('name')}"
                   f" without a live block")
    if live is not None and muts is None:
        out.append(f"{name}: live config {cfg.get('name')} under a mix "
                   f"without mutations")
    if muts is not None:
        for key in MUTATION_COUNTS:
            if not _count(muts.get(key)):
                out.append(f"{name}: mutations {key} {muts.get(key)!r}")
        if not muts.get("source"):
            out.append(f"{name}: mutations without a source")
    if live is not None:
        if not _count(live.get("delta_cap"), 1):
            out.append(f"{name}: live delta_cap {live.get('delta_cap')!r}")
        if not _count(live.get("merge_every")):
            out.append(f"{name}: live merge_every "
                       f"{live.get('merge_every')!r}")
        limits = cfg.get("check", {}).get("limits", {})
        for key in LIVE_LIMITS:
            if limits.get(key) != 0:
                out.append(f"{name}: live check limit {key} "
                           f"{limits.get(key)!r}, not 0")
    return out


def _share(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) \
        and 0 < x < 1


def _positive(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) and x > 0


def config_problems(cfg: dict) -> List[str]:
    """What breaks the rules of one configuration's ``policy`` block and
    its ``reference``: a kind other than ``cascade_patience``, ``tau``
    outside ``[2, n_probe]``, a threshold outside (0, 1), an Exit
    weight or a ``check.tree_tol`` that is no positive number, train
    counts that are no positive whole numbers, a policy beside a
    ``live`` block, and a ``reference`` that is not the one the blocks
    call for."""
    name = cfg.get("name")
    pol = cfg.get("policy")
    out = []
    if pol is not None:
        if pol.get("kind") not in POLICY_KINDS:
            out.append(f"{name}: policy kind {pol.get('kind')!r}")
        tau = pol.get("tau")
        if not (_count(tau, 2) and isinstance(cfg.get("n_probe"), int)
                and tau <= cfg["n_probe"]):
            out.append(f"{name}: policy tau {tau!r} outside [2, n_probe]")
        if not _share(pol.get("clf_threshold")):
            out.append(f"{name}: policy clf_threshold "
                       f"{pol.get('clf_threshold')!r} outside (0, 1)")
        if not _positive(pol.get("exit_weight")):
            out.append(f"{name}: policy exit_weight "
                       f"{pol.get('exit_weight')!r}")
        train = pol.get("train")
        for key in TRAIN_COUNTS:
            v = train.get(key) if isinstance(train, dict) else None
            if not _count(v, 1):
                out.append(f"{name}: policy train {key} {v!r}")
        if "live" in cfg:
            out.append(f"{name}: a policy block beside a live block")
        if not _positive(cfg.get("check", {}).get("tree_tol")):
            out.append(f"{name}: policy without a check.tree_tol")
    kind = "policy" if pol is not None else \
        "live" if "live" in cfg else None
    if cfg.get("reference") != REFERENCES[kind]:
        out.append(f"{name}: reference {cfg.get('reference')!r}, not "
                   f"{REFERENCES[kind]}")
    return out


def problems(root: Path) -> List[str]:
    """What in ``root/BENCHMARK.json`` breaks the harness's rules: names
    and units of the allowed characters, unique names, every file named
    present, every cell that reports a per-layer metric reporting
    the end-to-end metric it ``moves``, live cells as
    :func:`live_problems` says and configurations as
    :func:`config_problems` says."""
    bench = load_json(root / "BENCHMARK.json")
    out = []
    if set(bench) != TOP_KEYS:
        out.append(f"top-level keys {sorted(bench)}")
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    names = [*cells, *configs, *e2e, *(m["name"] for m in bench["per_layer"])]
    for group in (cells, configs,
                  [m["name"] for m in bench["end_to_end"]
                   + bench["per_layer"]]):
        if len(set(group)) != len(list(group)):
            out.append(f"duplicate names in {sorted(group)}")
    for n in names:
        if not NAME.match(n):
            out.append(f"bad name {n!r}")
    for c in configs.values():
        if not (root / c["file"]).is_file():
            out.append(f"config file {c['file']} missing")
        else:
            out += config_problems(load_json(root / c["file"]))
        for key in c["reduced"]:
            if not NAME.match(key):
                out.append(f"bad reduced key {key!r}")
    for w in cells.values():
        if w["config"] not in configs:
            out.append(f"{w['name']}: unknown config {w['config']}")
        if not NAME.match(w["traffic"]):
            out.append(f"bad traffic name {w['traffic']!r}")
        elif not (root / "portbench" / "traffic"
                  / f"{w['traffic']}.json").is_file():
            out.append(f"{w['name']}: traffic file missing")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips {w['chips']}")
        mix = root / "portbench" / "traffic" / f"{w['traffic']}.json"
        cfg = configs.get(w["config"])
        if cfg is not None and mix.is_file() \
                and (root / cfg["file"]).is_file():
            out += live_problems(w["name"], load_json(root / cfg["file"]),
                                 load_json(mix))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better {m['better']!r}")
        if not (root / "portbench" / "metrics"
                / f"{m['name']}.py").is_file():
            out.append(f"{m['name']}: no reader file")
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"{m['name']}: unknown workload {c}")
    for m in bench["end_to_end"]:
        if m["source"] not in SOURCES_E2E:
            out.append(f"{m['name']}: end-to-end source {m['source']}")
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']}")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in bench["per_layer"]:
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: source {m['source']}")
        moved = e2e.get(m["moves"])
        if moved is None:
            out.append(f"{m['name']}: moves unknown {m['moves']}")
            continue
        for c in m.get("workloads", list(cells)):
            if not _reported(moved, c):
                out.append(f"{m['name']}: cell {c} does not report "
                           f"{m['moves']}")
    for c in cells:
        ends = [m["name"] for m in bench["end_to_end"] if _reported(m, c)]
        if "setup_s" not in ends or len(ends) < 2:
            out.append(f"{c}: end-to-end metrics {ends}")
        if not any(_reported(m, c) for m in bench["per_layer"]):
            out.append(f"{c}: no per-layer metric")
    return out

