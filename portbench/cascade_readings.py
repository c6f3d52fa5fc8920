"""The cascade reference against the program's batch ``search``, in one
process: for a configuration file with a ``policy`` block and a traffic
mix, and for each seed, the corpus and the pool made, the exit trees
trained (``policy.py``), the program's fused ``search`` under
``cascade_patience`` with those trees over the first ``--queries`` pool
queries, and its answers and the control's (the cascade reference in
TF32) judged against the reference on every one of them.  One JSON line
a seed; with ``--explain``, after it one line (``"mismatch"``) for each
answer that parts from the reference (``judge.explain``).

    python3 portbench/cascade_readings.py \\
        --config <config with a policy block>.json \\
        --traffic msmarco-dev-small --seeds 11 12 13

Beside the judged numbers a line holds the trees' training seconds,
the mean probes of the program, of the cascade reference and of the
plain patience reference on the same queries, and ``feature_gap``: the
widest distance between the program's float32 features at ``tau``
(``SearchResult.features``) and the reference's float64 ones, over the
queries with no tie within ``tie_tol`` through probe ``tau`` (what
``check.tree_tol`` must cover), and the widest distance between the
program's margin on its features and the reference's, over those of
them whose paths pass no split within ``tree_tol``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def measure(cfg: dict, mix: dict, seed: int, dev, n_queries: int,
            explain: bool = False) -> dict:
    """The readings of one seed (the module's docstring)."""
    import numpy as np
    import torch
    from repro_torch.core.ivf import IVFIndex, search
    from repro_torch.trees.torch_infer import predict_margin

    from portbench import corpus as corpus_mod
    from portbench import harness, judge, policy
    from portbench.reference import ivf_patience

    def now():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    c = corpus_mod.make(cfg, mix["pool"], seed, dev)
    forest, took = policy.train(c, cfg, seed)
    index = IVFIndex(c.centroids, c.docs, c.doc_ids, c.offsets, c.sizes,
                     c.list_pad)
    pol = harness.program_policy(forest, cfg, dev)
    idx = np.arange(min(n_queries, c.pool.shape[0]))
    t = now()
    ids, probes, feats, margins = [], [], [], []
    for s in range(0, idx.shape[0], cfg["wave_size"]):
        res = search(index, c.pool[s:s + cfg["wave_size"]], pol,
                     use_fused_kernel=True, chunk=cfg["chunk"])
        ids.append(res.topk_ids.long().cpu())
        probes.append(res.probes.long().cpu())
        feats.append(res.features.double())
        margins.append(predict_margin(pol.clf, res.features).double())
    search_s = now() - t
    del index, pol
    ans = judge.Answers(idx, torch.cat(ids).numpy(), torch.cat(probes).numpy())
    t = now()
    ref, inv = judge.reference_of(c, cfg, idx, forest=forest)
    reference_s = now() - t
    out = {"seed": seed, "queries": int(idx.shape[0]), "train": took,
           "search_s": search_s, "reference_s": reference_s,
           "program": judge.compare(c, cfg, ans, ref, inv)}
    ctl = judge.control_answers(c, cfg, idx, forest=forest)
    out["control"] = judge.compare(c, cfg, ctl, ref, inv)
    q = c.pool[torch.as_tensor(idx, device=dev)]
    tau = cfg["policy"]["tau"]
    pat = ivf_patience.search(
        q, c.docs, c.doc_ids, c.offsets, c.sizes, c.centroids, k=cfg["k"],
        n_probe=cfg["n_probe"], delta=cfg["patience_delta"],
        phi=cfg["patience_phi"], list_pad=cfg["list_pad"])
    out["mean_probes"] = {"program": float(ans.probes.mean()),
                          "cascade_reference": float(
                              ref.probes.double().mean()),
                          "patience_reference": float(
                              pat.probes.double().mean())}
    del pat
    mg = ivf_patience.margins(
        q, c.docs, c.doc_ids, c.offsets, c.sizes, c.centroids, k=cfg["k"],
        n_probe=tau, list_pad=cfg["list_pad"])
    tol = cfg["check"]["tie_tol"]
    untied = (mg.boundary.amin(1) >= tol) & (mg.centroid.amin(1) >= tol)
    gap = (torch.cat(feats)
           - ref.features[torch.as_tensor(inv, device=dev)]).abs()
    gap = gap.amax(1)
    # the margins where no split lies within tree_tol of its feature
    apart = untied & (ref.split_gap[torch.as_tensor(inv, device=dev)]
                      >= cfg["check"]["tree_tol"])
    mgap = (torch.cat(margins)
            - ref.margin[torch.as_tensor(inv, device=dev)]).abs()
    out["feature_gap"] = {
        "untied_queries": int(untied.sum()),
        "max_untied": float(gap[untied].max()) if untied.any() else 0.0,
        "max_all": float(gap.max()),
        "apart_queries": int(apart.sum()),
        "margin_max_apart": float(mgap[apart].max()) if apart.any()
        else 0.0,
        "split_gap_min": float(ref.split_gap.min())}
    if explain:
        out["mismatches"] = judge.explain(c, cfg, ans, ref, inv)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--queries", type=int, default=1 << 30)
    ap.add_argument("--explain", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.run import fixed_caches
    fixed_caches(ROOT)
    import torch
    from portbench import spec

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cfg = spec.load_json(Path(args.config))
    mix = spec.load_json(ROOT / "portbench" / "traffic"
                         / f"{args.traffic}.json")
    bad = spec.config_problems(cfg)
    if "policy" not in cfg or bad:
        print(f"{args.config}: not a policy configuration {bad}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        out = measure(cfg, mix, seed, dev, args.queries, args.explain)
        mismatches = out.pop("mismatches", [])
        print(json.dumps(out), flush=True)
        for m in mismatches:
            print(json.dumps({"mismatch": cfg["name"], "seed": seed, **m}),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
