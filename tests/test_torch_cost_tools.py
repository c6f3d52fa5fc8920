"""The port's cost tools against the reference's: ``distributed/sharding``'s
partition rules leaf by leaf on both production meshes (the reference on
an ``AbstractMesh``, so no process forces 512 devices), every family's
reduced dry-run cell on a fake (2, 4) group, the FLOP count of a reduced
LM train cell against its products, ``roofline.analyse`` and the
hillclimb's ``moe_a2a`` fault (ROADMAP R7)."""
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch, list_archs, reduced
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cells, cost_analysis, dryrun
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tf

ROOT = Path(__file__).resolve().parent.parent
LM = [a for a in list_archs() if get_arch(a).family == "lm"]
RECSYS = [a for a in list_archs() if get_arch(a).family == "recsys"]


@pytest.fixture(scope="module")
def ref():
    """The reference package, imported here only (the card's machine has
    no JAX)."""
    import jax
    from jax.sharding import AbstractMesh
    from repro.configs import get_arch as j_get_arch
    from repro.distributed import sharding as jshd
    from repro.models import gnn as jgnn
    from repro.models import recsys as jrec
    from repro.models import transformer as jtf
    return dict(jax=jax, AbstractMesh=AbstractMesh, get_arch=j_get_arch,
                shd=jshd, gnn=jgnn, rec=jrec, tf=jtf)


def _mesh_pair(ref, multi):
    shape, names = production_mesh_shape(multi)
    return ref["AbstractMesh"](shape, names), (shape, names)


def _ref_leaves(ref, specs):
    P = ref["jax"].sharding.PartitionSpec
    return {ref["jax"].tree_util.keystr(k): tuple(v) for k, v in
            ref["jax"].tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, P))}


def _port_leaves(specs, path=""):
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_port_leaves(v, f"{path}['{k}']"))
        return out
    if isinstance(specs, list):
        out = {}
        for i, v in enumerate(specs):
            out.update(_port_leaves(v, f"{path}[{i}]"))
        return out
    return {path: specs}


def _abstract_port(init):
    return cells._abstract(init)


# ---------------------------------------------------------------------------
# partition rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", LM)
def test_lm_param_specs_match_reference(ref, arch, multi):
    jmesh, tmesh = _mesh_pair(ref, multi)
    cfg = get_arch(arch).model
    want = _ref_leaves(ref, ref["shd"].lm_param_specs(
        ref["tf"].abstract_params(ref["get_arch"](arch).model), jmesh))
    got = _port_leaves(shd.lm_param_specs(
        _abstract_port(functools.partial(tf.init_params, cfg)), tmesh))
    n_stack = cfg.n_layers - (cfg.moe.first_k_dense if cfg.moe else 0)
    checked = 0
    for path, spec in got.items():
        m = re.match(r"\['layers'\]\[(\d+)\](.*)$", path)
        if m:
            # the reference stacks the layers on a leading scan axis (a
            # replicated leaf's spec is P() either way)
            w = want["['layers']" + m.group(2)]
            assert spec == (w[1:] if w else ()) and (not w or w[0] is None), \
                path
        else:
            assert spec == want[path], path
        checked += 1
    assert checked == len(got) and len(got) == len(want) + \
        (n_stack - 1) * sum(1 for p in want if p.startswith("['layers']"))


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", LM)
def test_lm_cache_specs_match_reference(ref, arch, shape, multi):
    jmesh, tmesh = _mesh_pair(ref, multi)
    dims = {s.name: s.dims for s in get_arch(arch).shapes}[shape]
    bs, seq = dims["global_batch"], dims["seq_len"]
    long = shape == "long_500k"
    jc = ref["tf"].abstract_cache(ref["get_arch"](arch).model, bs, seq)
    want = ref["shd"].lm_cache_specs(jc, jmesh, seq_sharded=long).data
    tc = tf.init_cache(get_arch(arch).model, bs, seq, device="meta")
    got = shd.lm_cache_specs(tc, tmesh, seq_sharded=long)
    assert got == tuple(tuple(w) for w in want)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_param_specs_match_reference(ref, arch, multi):
    jmesh, tmesh = _mesh_pair(ref, multi)
    jcfg = ref["get_arch"](arch).model
    jp = ref["jax"].eval_shape(functools.partial(ref["rec"].init_params,
                                                 jcfg),
                               ref["jax"].random.PRNGKey(0))
    want = _ref_leaves(ref, ref["shd"].recsys_param_specs(jp, jmesh))
    got = _port_leaves(shd.recsys_param_specs(_abstract_port(
        functools.partial(recsys.init_params, get_arch(arch).model)), tmesh))
    assert got == want


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_gnn_specs_match_reference(ref, multi):
    jmesh, tmesh = _mesh_pair(ref, multi)
    cfg = get_arch("gat-cora").model
    jp = ref["jax"].eval_shape(functools.partial(ref["gnn"].init_params, cfg),
                               ref["jax"].random.PRNGKey(0))
    want = _ref_leaves(ref, ref["shd"].gnn_param_specs(jp))
    got = _port_leaves(shd.gnn_param_specs(_abstract_port(
        functools.partial(gnn.init_params, cfg))))
    assert got == want
    wi = ref["shd"].gnn_input_specs(jmesh)
    ti = shd.gnn_input_specs(tmesh)
    for f in ("feat", "edge_src", "edge_dst", "label"):
        assert getattr(ti, f) == tuple(getattr(wi, f)), f
    assert ti.edge_mask is None and wi.edge_mask is None
    assert shd.dp_axes(tmesh) == ref["shd"].dp_axes(jmesh)


def test_fit_and_placements():
    mesh = ((2, 4), ("data", "model"))
    assert shd.fit(("model", "data"), (73448, 64), ((16, 16),
                                                    ("data", "model"))) \
        == (None, "data")
    assert shd.fit((("data", "model"), None), (16, 3), mesh) == \
        (("data", "model"), None)
    assert shd.fit((("data", "model"), None), (12, 3), mesh) == (None, None)
    from torch.distributed.tensor import Replicate, Shard

    class M:
        mesh_dim_names = ("data", "model")
    assert shd.placements(("model", "data"), M) == (Shard(1), Shard(0))
    assert shd.placements((("data", "model"), None), M) == \
        (Shard(0), Shard(0))
    assert shd.placements((), M) == (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# reduced cells on a fake (2, 4) group
# ---------------------------------------------------------------------------


def _reference_record_keys():
    """The keys the reference's ``run_cell`` writes into an ok record,
    read from its source (running it needs 512 placeholder devices)."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    body = src[src.index("def run_cell"):src.index("def main")]
    keys = set(re.findall(r'rec\["(\w+)"\]\s*=', body))
    keys |= set(re.findall(r'"(\w+)":', body.split("rec: Dict = ")[1]
                           .split("}")[0]))
    return keys - {"error", "traceback"}


REDUCED = [("starcoder2-3b", "smoke_train"), ("starcoder2-3b", "smoke_decode"),
           ("minicpm3-4b", "smoke_train"), ("deepseek-moe-16b", "smoke_train"),
           ("gat-cora", "smoke_graph"), ("deepfm", "smoke_train"),
           ("two-tower-retrieval", "smoke_serve"),
           ("msmarco-ivf", "smoke_serve")]


@pytest.mark.parametrize("arch,shape", REDUCED)
def test_reduced_cell_records_ok(arch, shape):
    spec = reduced(get_arch(arch))
    rec = dryrun.record(spec, shape, (2, 4), ("data", "model"))
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == _reference_record_keys() | {"compile_s"}
    assert rec["n_devices"] == 8 and rec["cost_method"] == "direct"
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
    assert rec["memory"]["peak_gb"] >= rec["memory"]["argument_gb"] > 0
    assert not dist.is_initialized()          # the fake group is gone
    if spec.family in ("lm", "gnn", "ivf"):
        assert rec["collectives"]["total_bytes"] > 0


def test_moe_train_cell_counts_the_expert_gradients(monkeypatch):
    """The MoE layers of a train cell run ``moe_forward``'s mesh path,
    whose expert weights are gathered from their DP shards on use: the
    backward reduce-scatters each one's gradient back (the transpose of
    the reference's gather), once a weight a layer, and runs the expert
    FFNs' backward.  Against the same cell with the gathers' gradients
    cut (the collectives outside autograd)."""
    from repro_torch.distributed import collectives
    from repro_torch.models import moe

    spec = reduced(get_arch("deepseek-moe-16b"))
    cfg = spec.model
    rec = dryrun.record(spec, "smoke_train", (2, 4), ("data", "model"))
    monkeypatch.setattr(moe, "gather_shards", collectives.all_gather)
    monkeypatch.setattr(moe, "gather_blocks", collectives.all_gather)
    monkeypatch.setattr(moe, "sum_over", collectives.all_reduce)
    monkeypatch.setattr(moe, "copy_to", lambda x, group: x)
    cut = dryrun.record(spec, "smoke_train", (2, 4), ("data", "model"))
    assert rec["status"] == cut["status"] == "ok", rec.get("traceback")
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    count, count_cut = (r["collectives"]["count_by_kind"] for r in (rec, cut))
    assert count["reduce-scatter"] - count_cut["reduce-scatter"] == 3 * n_moe
    assert rec["cost"]["flops"] > cut["cost"]["flops"]


def test_dryrun_cli_writes_a_record(tmp_path, capsys):
    rc = dryrun.main(["--arch", "gat-cora", "--shape", "molecule",
                      "--out", str(tmp_path)])
    assert rc == 0 and "[OK ] gat-cora" in capsys.readouterr().out
    rec = json.loads((tmp_path / "gat-cora__molecule__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert set(rec["collectives"]["bytes_by_kind"]) <= \
        set(cost_analysis.COLLECTIVE_KINDS)
    assert not dist.is_initialized()


def test_a_failing_cell_records_fail_and_the_run_goes_on(tmp_path,
                                                         monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no rule")

    monkeypatch.setattr(cells, "_gnn_cell", boom)
    rc = dryrun.main(["--arch", "gat-cora", "--shape", "molecule",
                      "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "gat-cora__molecule__single.json")
                     .read_text())
    assert rc == 1 and rec["status"] == "fail"
    assert rec["error"] == "RuntimeError: no rule"
    assert not dist.is_initialized()


def _lm_train_flops(cfg, b, s):
    """The train step's product flops: each layer's and the head's
    products run forward, again in the remat recompute, and twice in the
    backward (both operands need gradients), except the layer's last
    product (the FFN's output projection): its result is saved for no
    backward, so the non-reentrant checkpoint's recompute stops before
    it."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim()
    t = b * s
    layer = 2 * t * d * (h + 2 * kv) * hd + 2 * t * h * hd * d
    layer += 2 * 2 * b * h * s * s * hd        # q k^T and p v, all keys
    n_mlp = 3 if cfg.mlp_type == "swiglu" else 2
    layer += n_mlp * 2 * t * d * cfg.d_ff
    head = 2 * t * d * cfg.vocab_size
    return 4 * (cfg.n_layers * layer + head) \
        - cfg.n_layers * 2 * t * cfg.d_ff * d


def test_train_cell_flops_are_its_products_and_count_every_layer():
    """On one device the direct count equals the products' flops (remat's
    recompute included); at L layers it is ``L1 + (L - 1)(L2 - L1)``, the
    identity the reference's unrolled L1/L2 delta relies on."""
    spec = reduced(get_arch("starcoder2-3b"))
    flops = {}
    for n_layers in (1, 2, 3):
        cfg = dataclasses.replace(spec.model, n_layers=n_layers)
        s = dataclasses.replace(spec, model=cfg)
        rec = dryrun.record(s, "smoke_train", (1, 1), ("data", "model"))
        assert rec["status"] == "ok", rec.get("traceback")
        flops[n_layers] = rec["cost"]["flops"]
        dims = spec.shapes[0].dims
        assert flops[n_layers] == _lm_train_flops(
            cfg, dims["global_batch"], dims["seq_len"])
    assert flops[3] == flops[1] + 2 * (flops[2] - flops[1])


def test_counter_counts_explicit_collectives_and_live_memory():
    with dryrun.fake_group(8):
        from repro_torch.distributed.collectives import all_gather, all_reduce
        from repro_torch.launch.mesh import axis_group, make_local_mesh
        mesh = make_local_mesh(2, 4)
        model = axis_group(mesh, "model")
        x = torch.empty((64, 8), device="meta")

        def fn(x):
            y = all_reduce(x * 2.0, model)
            return all_gather(y, model)

        out, c = cost_analysis.count(fn, x)
    assert c.collectives.count_by_kind == {"all-reduce": 1, "all-gather": 1}
    assert c.collectives.bytes_by_kind == {"all-reduce": 64 * 8 * 4,
                                           "all-gather": 4 * 64 * 8 * 4}
    mem = c.memory([out])
    assert mem["argument_gb"] == 64 * 8 * 4 / 1e9
    assert mem["output_gb"] == 4 * 64 * 8 * 4 / 1e9 and mem["alias_gb"] == 0


# ---------------------------------------------------------------------------
# roofline and hillclimb
# ---------------------------------------------------------------------------


def test_roofline_analyse_matches_reference(monkeypatch, tmp_path):
    import benchmarks.roofline as jroof
    import repro.launch.hlo_analysis as jhlo
    from repro_torch.benchmarks import roofline

    for name, value in (("PEAK_FLOPS", cost_analysis.PEAK_FLOPS),
                        ("HBM_BW", cost_analysis.HBM_BW),
                        ("ICI_BW", cost_analysis.LINK_BW)):
        monkeypatch.setattr(jhlo, name, value)
    rec = dryrun.record(reduced(get_arch("deepfm")), "smoke_train", (2, 4),
                        ("data", "model"))
    assert roofline.analyse(rec) == jroof.analyse(rec)
    assert roofline.analyse({**rec, "status": "fail"}) == \
        jroof.analyse({**rec, "status": "fail"})
    (tmp_path / "deepfm__smoke_train__single.json").write_text(
        json.dumps(rec))
    rows = roofline.main("single", art=str(tmp_path))
    assert rows[0]["ok"] and (tmp_path / "roofline_single.json").exists()


def test_moe_a2a_raises_type_error_in_both_packages(monkeypatch):
    """ROADMAP R7: ``moe_a2a`` asks for ``MoEConfig.a2a_dispatch``, which
    neither package has (the dry runs themselves stubbed out)."""
    from repro_torch.benchmarks import hillclimb

    monkeypatch.setattr(hillclimb, "_run", lambda *a, **k: None)
    with pytest.raises(TypeError, match="a2a_dispatch"):
        hillclimb.moe_a2a()
    code = ("import benchmarks.hillclimb as h\n"
            "h._run = lambda *a, **k: None\n"
            "try:\n    h.moe_a2a()\n"
            "except TypeError as e:\n    print('TypeError', e)\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert "TypeError" in out.stdout and "a2a_dispatch" in out.stdout, \
        out.stderr[-2000:]
