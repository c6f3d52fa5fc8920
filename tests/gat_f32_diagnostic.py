"""The GAT's first full_graph_sm step in f32 on the CPU, the port's and
the reference's, against the port's f64 step, on GAT weights drawn on a
card.

``chip_smoke.py``'s ``gnn_full_graph_sm`` hold draws gat-cora's weights
with ``gnn.init_params(cfg, seed=0)`` on the card.  On those weights the
port's f32 step on the CPU is off its f64 step by 7.4e-3 of layer 0's
a_dst gradient, where the card's f32 step is within 1e-6.  This script
reads whether the reference's f32 step shares that error, which product
of the port's step carries it, and how many of layer 0's attention
logits that product's rounding puts across the leaky ReLU's kink (where
the gradient jumps from slope 0.2 to 1).

Two modes, the first on a card's machine (the port alone, no JAX), the
second on the CPU (JAX and the port):

    PYTHONPATH=src python tests/gat_f32_diagnostic.py --dump weights.npz
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/gat_f32_diagnostic.py \\
        --compare weights.npz

``--compare`` prints, for each step, the worst gradient leaf's max |error|
over its max |f64 value|: the reference's f32 and f64 steps, the port's
f32 step, and the port's f32 step with layer 0's (N, F) x (F, H*D)
product taken otherwise (numpy's f32 product, torch's in 64-row blocks,
or rounded from f64), the product's own error beside them.
"""
import argparse
import dataclasses
import functools
import sys

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data.synthetic import random_graph
from repro_torch.launch.train import value_and_grad
from repro_torch.models import gnn

SHAPE = "full_graph_sm"


def _setup():
    spec = get_arch("gat-cora")
    d = {s.name: s.dims for s in spec.shapes}[SHAPE]
    cfg = dataclasses.replace(spec.model, d_in=d["d_feat"])
    g = random_graph(d["n_nodes"], d["n_edges"], d["d_feat"],
                     cfg.n_classes, seed=0)
    return cfg, g


def dump(path):
    cfg, _ = _setup()
    p = gnn.init_params(cfg, seed=0, device="cuda")
    np.savez(path, **{f"{a}.{k}": v.detach().cpu().numpy()
                      for a in p for k, v in p[a].items()})


def _tree(path):
    tree = {}
    with np.load(path) as z:
        for k in z.files:
            a, b = k.split(".")
            tree.setdefault(a, {})[b] = z[k]
    return tree


def _worst(got, want):
    out = {}
    for a in want:
        for b in want[a]:
            scale = float(np.abs(want[a][b]).max())
            if scale:
                out[f"{a}.{b}"] = float(np.abs(got[a][b] - want[a][b])
                                        .max()) / scale
    k = max(out, key=out.get)
    return k, out[k]


def compare(path):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from repro.configs import get_arch as j_get_arch
    from repro.models import gnn as jgnn

    cfg, g = _setup()
    jcfg = dataclasses.replace(j_get_arch("gat-cora").model, d_in=cfg.d_in)
    tree = _tree(path)
    einsum = torch.einsum

    def port(dtype, product=None):
        def ein(eq, *ops):
            y = einsum(eq, *ops)
            if product is None or eq != "nf,fhd->nhd" or \
                    ops[0].requires_grad:       # layer 0's: x is the input
                return y
            return y + (product(*ops) - y).detach()

        graph = gnn.Graph(torch.from_numpy(g["feat"]).to(dtype),
                          *(torch.from_numpy(g[k]) for k in
                            ("edge_src", "edge_dst", "label")))
        params = {a: {b: torch.from_numpy(v).to(dtype) for b, v in d.items()}
                  for a, d in tree.items()}
        gnn.torch.einsum = ein
        try:
            _, grads = value_and_grad(
                functools.partial(gnn.loss_fn, cfg, g=graph), params)
        finally:
            gnn.torch.einsum = einsum
        return {a: {b: t.double().numpy() for b, t in d.items()}
                for a, d in grads.items()}

    def ref(dtype):
        graph = jgnn.Graph(jnp.asarray(g["feat"], dtype),
                           *(jnp.asarray(g[k]) for k in
                             ("edge_src", "edge_dst", "label")))
        params = jax.tree.map(lambda v: jnp.asarray(v, dtype), tree)
        _, grads = jax.jit(jax.value_and_grad(
            functools.partial(jgnn.loss_fn, jcfg), has_aux=True))(
                params, graph)
        return jax.tree.map(lambda t: np.asarray(t, np.float64), grads)

    def numpy_f32(x, w):
        return torch.from_numpy(np.einsum("nf,fhd->nhd", x.numpy(),
                                          w.detach().numpy()))

    def blocks(x, w):
        w2 = w.detach().reshape(x.shape[1], -1)
        return torch.cat([x[i: i + 64] @ w2 for i in
                          range(0, x.shape[0], 64)]).reshape(
                              x.shape[0], *w.shape[1:])

    def from_f64(x, w):
        return einsum("nf,fhd->nhd", x.double(), w.detach().double()).float()

    base = port(torch.float64)
    rows = {"reference f64": ref(jnp.float64),
            "reference f32": ref(jnp.float32),
            "port f32": port(torch.float32),
            "port f32, layer 0's product by numpy f32": port(torch.float32,
                                                             numpy_f32),
            "port f32, the product in 64-row blocks": port(torch.float32,
                                                           blocks),
            "port f32, the product rounded from f64": port(torch.float32,
                                                           from_f64)}
    for name, grads in rows.items():
        leaf, err = _worst(grads, base)
        print(f"{name}: worst leaf {leaf} {err:.3e} of its scale")
    x = torch.from_numpy(g["feat"])
    w = torch.from_numpy(tree["layer_0"]["w"])
    exact = einsum("nf,fhd->nhd", x.double(), w.double())
    for name, fn in (("torch f32", lambda: einsum("nf,fhd->nhd", x, w)),
                     ("numpy f32", lambda: numpy_f32(x, w)),
                     ("64-row blocks", lambda: blocks(x, w))):
        h = fn()
        err = float((h.double() - exact).abs().max() / exact.abs().max())
        # the edge logits' leaky ReLU: an (edge, head) whose f32
        # pre-activation lies across the kink from its f64 value
        pre, pre64 = _pre(h, tree, g), _pre(exact, tree, g, torch.float64)
        across = (pre > 0) != (pre64 > 0)
        print(f"layer 0's product, {name}: {err:.3e} of its scale; "
              f"{int(across.sum())} (edge, head) pre-activations across "
              f"the leaky ReLU's kink from f64 (f64 "
              f"{pre64[across].tolist()}, f32 {pre[across].tolist()})")


def _pre(h, tree, g, dtype=torch.float32):
    """Layer 0's (E, H) attention logits before the leaky ReLU."""
    a_src, a_dst = (torch.from_numpy(tree["layer_0"][k]).to(dtype)
                    for k in ("a_src", "a_dst"))
    src, dst = (torch.from_numpy(g[k]).long() for k in ("edge_src",
                                                       "edge_dst"))
    h = h.to(dtype)
    return torch.einsum("nhd,hd->nh", h, a_src)[src] + \
        torch.einsum("nhd,hd->nh", h, a_dst)[dst]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--dump", metavar="NPZ")
    mode.add_argument("--compare", metavar="NPZ")
    a = ap.parse_args(argv)
    if a.dump:
        dump(a.dump)
    else:
        compare(a.compare)


if __name__ == "__main__":
    sys.exit(main())
