"""Assigned-architecture tour: GAT full-graph + sampled minibatch, and a
recsys CTR model, all through the public config registry (port of
``examples/gnn_and_recsys.py``).

    PYTHONPATH=src python -m repro_torch.examples.gnn_and_recsys \
        [--device cpu]
"""
import argparse
import dataclasses
import functools

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, reduced
from repro_torch.data.graph_sampler import (CSRGraph, block_shapes,
                                            pad_block, sample_blocks)
from repro_torch.data.synthetic import click_log, random_graph
from repro_torch.launch.train import value_and_grad
from repro_torch.models import gnn, recsys
from repro_torch.optim.optimizers import adamw


def gat_demo(dev, steps=100):
    """Returns (loss, acc) after ``steps`` full-graph AdamW steps and the
    sampled block forward's output shape."""
    cfg = dataclasses.replace(reduced(get_arch("gat-cora")).model,
                              d_in=32, n_classes=5)
    g_np = random_graph(400, 2000, 32, 5, seed=0)
    graph = gnn.Graph(*(torch.from_numpy(g_np[k]).to(dev) for k in
                        ("feat", "edge_src", "edge_dst", "label")))
    params = gnn.init_params(cfg, seed=0, device=dev)
    opt = adamw(0.02, weight_decay=0.0)
    state = opt.init(params)
    for i in range(steps):
        loss, grads = value_and_grad(
            functools.partial(gnn.loss_fn, cfg, g=graph), params)
        params, state = opt.update(grads, state, params, i)
    _, m = gnn.loss_fn(cfg, params, graph)
    print(f"GAT full-graph: loss={float(loss):.3f} acc={float(m['acc']):.2f}")

    # sampled-minibatch path (the minibatch_lg cell's machinery)
    csr = CSRGraph.from_edges(g_np["edge_src"], g_np["edge_dst"], 400)
    rng = np.random.default_rng(0)
    seeds = rng.choice(400, 32, replace=False)
    blocks = sample_blocks(csr, seeds, (5, 3), rng)
    shapes = block_shapes(32, (5, 3))
    padded = [pad_block(b, e, n) for b, (e, n, _) in zip(blocks, shapes)]
    feats = graph.feat[torch.from_numpy(padded[-1].nodes).to(dev).long()]
    bl = [{k: torch.from_numpy(getattr(b, k)).to(dev)
           for k in ("edge_src", "edge_dst", "edge_mask")} for b in padded]
    with torch.no_grad():
        out = gnn.forward_blocks(cfg, params, feats, bl,
                                 tuple(o for (_, _, o) in shapes))
    print(f"GAT minibatch block forward: {tuple(out.shape)} (fanout 5-3)")
    return float(loss), float(m["acc"]), tuple(out.shape)


def recsys_demo(dev, steps=50):
    """Returns DCN-v2's losses over ``steps`` AdamW steps."""
    cfg = reduced(get_arch("dcn-v2")).model
    params = recsys.init_params(cfg, seed=0, device=dev)
    opt = adamw(1e-2)
    state = opt.init(params)
    losses = []
    for i in range(steps):
        data = click_log(256, cfg.n_dense, cfg.n_sparse,
                         cfg.rows_per_field, seed=i)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        loss, grads = value_and_grad(
            functools.partial(recsys.loss_fn, cfg, batch=batch), params)
        params, state = opt.update(grads, state, params, i)
        losses.append(float(loss))
    print(f"DCN-v2 CTR: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


def main(*, gat_steps=100, recsys_steps=50, device=None):
    dev = resolve_device(device)
    return {"gat": gat_demo(dev, gat_steps),
            "dcn": recsys_demo(dev, recsys_steps)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    main(device=ap.parse_args().device)
