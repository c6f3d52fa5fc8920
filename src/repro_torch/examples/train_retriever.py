"""End to end: train a dual-encoder retriever contrastively,
embed the corpus, build the IVF index, and serve with adaptive early
exit — the full life cycle of the paper's system (port of
``examples/train_retriever.py``; training runs through the port's
AdamW and fault-tolerant trainer, the searches through the fused
``ivf_scan_merge`` kernel on the card).

    PYTHONPATH=src python -m repro_torch.examples.train_retriever \
        [--steps 300] [--big] [--ckpt <dir>] [--device cpu]

Training checkpoints land in ``--ckpt`` (restart-safe: rerun the
command after a crash and it resumes).
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import brute_force, build_index, metrics, policies, search
from repro_torch.core.training import choose_n_probe
from repro_torch.data.pipeline import pair_batcher
from repro_torch.data.synthetic import clustered_corpus
from repro_torch.launch.train import value_and_grad
from repro_torch.models.layers import dense, dense_init
from repro_torch.optim.optimizers import adamw, warmup_cosine
from repro_torch.runtime.fault import FaultTolerantTrainer

SMALL_DIMS = (256, 512, 512, 128)
BIG_DIMS = (256, 4096, 8192, 2048, 128)     # ~103M parameters, two towers


def encoder_init(gen: torch.Generator, dims):
    return {f"l{i}": dense_init(gen, dims[i], dims[i + 1], bias=True)
            for i in range(len(dims) - 1)}


def encode(params, x):
    n = len(params)
    for i in range(n):
        x = dense(params[f"l{i}"], x, dtype=torch.float32)
        if i < n - 1:
            x = F.gelu(x, approximate="tanh")       # jax.nn.gelu's default
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                               1e-6)


def contrastive_loss(params, batch):
    dev = params["q"]["l0"]["w"].device
    q = encode(params["q"], torch.as_tensor(batch["query"], device=dev))
    d = encode(params["d"], torch.as_tensor(batch["doc"], device=dev))
    logits = q @ d.T / 0.05
    labels = torch.arange(q.shape[0], device=dev)
    lse = torch.logsumexp(logits, dim=1)
    loss = (lse - torch.diagonal(logits)).mean()
    acc = (logits.argmax(1) == labels).float().mean()
    return loss, acc


def embed(params, x: np.ndarray, dev, block: int = 8192) -> torch.Tensor:
    """Encode host rows in blocks on ``dev``."""
    with torch.no_grad():
        return torch.cat([encode(params, torch.from_numpy(
            x[i: i + block]).to(dev)) for i in range(0, len(x), block)])


def main(*, steps=300, big=False, ckpt=None, n_docs=40_000,
         n_components=256, n_queries=1024, n_clusters=256, batch=128,
         device=None):
    """Returns the losses, N, each policy's metrics and what the search
    ran on (index, query embeddings, policies)."""
    dev = resolve_device(device)
    ckpt = ckpt or os.path.join(tempfile.gettempdir(),
                                "repro_torch_retriever")
    raw_dim = 256
    dims = BIG_DIMS if big else SMALL_DIMS
    n_params = sum((dims[i] + 1) * dims[i + 1]
                   for i in range(len(dims) - 1)) * 2
    print(f"dual encoder: {dims}, ~{n_params / 1e6:.1f}M params")

    print(f"corpus: {n_docs} docs in raw feature space...")
    c = clustered_corpus(n_docs=n_docs, dim=raw_dim,
                         n_components=n_components, n_queries=n_queries,
                         spread=0.3, seed=0)
    opt = adamw(warmup_cosine(3e-4, 50, steps))

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(0)
        params = {"q": encoder_init(gen, dims), "d": encoder_init(gen, dims)}
        return params, opt.init(params), torch.zeros((), dtype=torch.int32,
                                                     device=dev)

    def step_fn(state, batch_):
        params, opt_state, i = state
        loss, grads = value_and_grad(
            lambda p: contrastive_loss(p, batch_), params)
        params, opt_state = opt.update(grads, opt_state, params, i)
        return (params, opt_state, i + 1), loss

    batcher = pair_batcher(c.docs, batch=batch, noise=0.08, seed=0)
    trainer = FaultTolerantTrainer(
        step_fn, init_state, batcher, CheckpointManager(ckpt, keep=2),
        ckpt_every=50, device=dev)
    t0 = time.time()
    rep = trainer.run(steps)
    print(f"trained {rep.steps_run} steps in {rep.wall_s:.0f}s "
          f"(loss {rep.losses[0]:.3f} -> {rep.losses[-1]:.3f}, "
          f"restarts={rep.restarts})")
    _, (params, _, _) = trainer.ckpt.restore(init_state(), device=dev)

    print("embedding corpus + building IVF index...")
    emb_docs = embed(params["d"], c.docs, dev).cpu().numpy()
    emb_q = embed(params["q"], c.queries, dev)
    index = build_index(emb_docs, n_clusters, list_pad=256, n_iters=6,
                        device=dev)

    emb_q_np = emb_q.cpu().numpy()
    n = choose_n_probe(index, emb_docs, emb_q_np[:256], rho=0.95, k=50,
                       n_max=n_clusters)
    print(f"N for R*@1>=0.95: {n}")
    _, exact = brute_force(torch.from_numpy(emb_docs).to(dev), emb_q, 50)
    exact = exact.cpu().numpy()
    pols = (policies.fixed(n, k=50, tau=5),
            policies.patience(n, delta=4, phi=95.0, k=50, tau=5))
    out = dict(losses=rep.losses, n_probe=n, index=index, queries=emb_q,
               policies=pols, results={})
    for pol in pols:
        res = search(index, emb_q, pol, use_fused_kernel=True, chunk=4)
        ids, probes = res.topk_ids.cpu().numpy(), res.probes.cpu().numpy()
        row = {"R*@1": metrics.r_star_at_1(ids, exact[:, 0]),
               "R@50": metrics.recall_at_k(ids, c.relevant),
               "C": float(probes.mean())}
        out["results"][pol.name] = row
        print(f"  {pol.name:12s} R*@1={row['R*@1']:.3f} "
              f"R@50={row['R@50']:.3f} C={row['C']:5.1f}")
    print(f"total {time.time() - t0:.0f}s")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--big", action="store_true",
                    help="~100M-param encoders")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    a = ap.parse_args()
    main(steps=a.steps, big=a.big, ckpt=a.ckpt, device=a.device)
