"""§Perf hillclimb driver (port of ``benchmarks/hillclimb.py``): one
experiment per hypothesis, each printing baseline vs candidate roofline
terms from the port's dry run (``launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.benchmarks.hillclimb qwen_remat
    PYTHONPATH=src python -m repro_torch.benchmarks.hillclimb ivf_width

``moe_a2a`` raises ``TypeError`` as the reference's does: it asks for a
``MoEConfig.a2a_dispatch`` field that neither package has.
"""
import dataclasses
import sys

from repro_torch.launch import dryrun as dr


def _run(arch, shape, out_tag, cfg_override=None):
    """run_cell with an optional model-config override."""
    from repro_torch.configs import base as cb
    spec = cb.get_arch(arch)
    if cfg_override:
        new = dataclasses.replace(spec.model, **cfg_override)
        patched = cb.ArchSpec(spec.arch_id, spec.family, new, spec.shapes,
                              spec.source)
        cb._REGISTRY[arch] = patched
    try:
        rec = dr.run_cell(arch, shape, False,
                          f"artifacts/hillclimb_torch/{out_tag}")
    finally:
        cb._REGISTRY[arch] = spec
    t = {}
    if rec.get("cost"):
        from repro_torch.launch.cost_analysis import roofline_terms
        terms = roofline_terms(rec["cost"]["flops"], rec["cost"]["bytes"],
                               rec["collectives"]["total_bytes"])
        t = {k: round(v * 1e3, 2) for k, v in terms.items()
             if k.endswith("_s")}
    print(f"[{out_tag}] {rec['status']} peak="
          f"{rec.get('memory', {}).get('peak_gb', float('nan')):.2f}GB "
          f"terms(ms)={t}")
    return rec


def qwen_bf16():
    print("HYPOTHESIS: bf16 stored params halve every FSDP all-gather "
          "(collective term ~ -40%) and cut HBM bytes; fp32 precision "
          "lives in the AdamW moments.")
    _run("qwen1.5-32b", "train_4k", "qwen_base")
    _run("qwen1.5-32b", "train_4k", "qwen_bf16",
         {"param_dtype": "bfloat16"})


def qwen_chunk():
    print("HYPOTHESIS: the (chunk,S) attention scan reshards per chunk; "
          "4x larger chunks cut the per-chunk collective count 4x at "
          "4x score-tile memory.")
    _run("qwen1.5-32b", "train_4k", "qwen_chunk512")
    _run("qwen1.5-32b", "train_4k", "qwen_chunk2048",
         {"attn_chunk": 2048})


def qwen_nomicro():
    print("HYPOTHESIS: microbatching (m=4) repeats weight gathers 4x; "
          "single-batch variant trades activation memory for fewer "
          "collectives.")
    _run("qwen1.5-32b", "train_4k", "qwen_m4")
    import repro_torch.launch.cells as cells
    orig = cells._microbatches
    cells._microbatches = lambda *a: 1
    try:
        _run("qwen1.5-32b", "train_4k", "qwen_m1")
    finally:
        cells._microbatches = orig


def qwen_remat():
    print("HYPOTHESIS: dots_saveable remat keeps matmul outputs, removing "
          "the backward re-all-gathers of the seq-parallel stream "
          "(collective term down) at the cost of HBM.")
    _run("qwen1.5-32b", "train_4k", "qwen_base")
    _run("qwen1.5-32b", "train_4k", "qwen_dots",
         {"remat_policy": "dots"})


def ivf_width():
    print("HYPOTHESIS: probing w clusters per loop step amortises the "
          "merge/all-gather/top-k per step (overhead/w); true scan "
          "bytes unchanged.")
    _run("msmarco-ivf", "ivf_serve_1k", "ivf_f32w1",
         {"storage_dtype": "float32", "probe_width": 1})
    _run("msmarco-ivf", "ivf_serve_1k", "ivf_bf16w1",
         {"storage_dtype": "bfloat16", "probe_width": 1})
    _run("msmarco-ivf", "ivf_serve_1k", "ivf_bf16w4",
         {"storage_dtype": "bfloat16", "probe_width": 4})
    _run("msmarco-ivf", "ivf_serve_1k", "ivf_int8w4",
         {"storage_dtype": "int8", "probe_width": 4})


def moe_a2a():
    print("HYPOTHESIS: manual all-to-all MoE dispatch (tokens sharded "
          "over model inside the body) removes the model-axis "
          "replication all-gathers that dominate dbrx train.")
    _run("dbrx-132b", "train_4k", "dbrx_base")
    _run("dbrx-132b", "train_4k", "dbrx_a2a",
         {"moe": dataclasses.replace(
             cbmodel("dbrx-132b").moe, a2a_dispatch=True)})


def cbmodel(arch):
    from repro_torch.configs import base as cb
    return cb.get_arch(arch).model


if __name__ == "__main__":
    globals()[sys.argv[1]]()
