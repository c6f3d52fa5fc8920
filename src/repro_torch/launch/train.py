"""Training entry point (port of ``repro.launch.train``): reduced configs
run on the CPU with ``--device cpu``, the full-width ones on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --smoke --steps 20 --ckpt-dir <dir> [--fail-at 7] [--device cpu]

A step is ``loss_fn``'s loss and its gradients by autograd (the flash
and embedding_bag kernels' ``Function``s on the card), then the
optimizer's update, which writes the params and moments in place.
"""
from __future__ import annotations

import argparse
import functools
import os
import tempfile
from typing import Callable, Dict, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch, reduced
from repro_torch.data import pipeline as pipe
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tf
from repro_torch.models.layers import tree_map
from repro_torch.optim.optimizers import Optimizer, adamw, warmup_cosine
from repro_torch.runtime.fault import FaultTolerantTrainer


def value_and_grad(fn: Callable, params) -> Tuple[torch.Tensor, Dict]:
    """``fn(params)``'s first output (a scalar loss) and its gradient
    with respect to every tensor of ``params`` (a tree of dicts and
    lists), zeros for one the loss does not reach."""
    leaves = []
    tree_map(lambda t: leaves.append(t.requires_grad_(True)), params)
    loss = fn(params)[0]
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def _make_step(loss_fn: Callable, opt: Optimizer) -> Callable:
    def step(state, batch):
        params, opt_state, step_idx = state
        loss, grads = value_and_grad(
            functools.partial(loss_fn, batch=batch), params)
        params, opt_state = opt.update(grads, opt_state, params, step_idx)
        return (params, opt_state, step_idx + 1), loss
    return step


def make_lm_step(cfg, opt: Optimizer) -> Callable:
    return _make_step(functools.partial(tf.loss_fn, cfg), opt)


def make_recsys_step(cfg, opt: Optimizer) -> Callable:
    return _make_step(functools.partial(rec_lib.loss_fn, cfg), opt)


def trainer_optimizer() -> Optimizer:
    """The trainer's optimizer, the reference's:
    ``adamw(warmup_cosine(1e-3, 20, 2000))``."""
    return adamw(warmup_cosine(1e-3, 20, 2000))


def build_trainer(arch: str, *, smoke: bool, ckpt_dir: str, seed: int = 0,
                  ckpt_every: int = 10, batch: int = 8, seq: int = 64,
                  device: DeviceLike = None) -> FaultTolerantTrainer:
    """The reference's trainer: :func:`trainer_optimizer`, seeded
    weights, the family's deterministic batcher, checkpoints (keep 2)
    every ``ckpt_every`` steps; on the card unless ``device="cpu"``.
    The state is built when the trainer first starts (the update writes
    it in place)."""
    spec = get_arch(arch)
    if smoke:
        spec = reduced(spec)
    cfg = spec.model
    opt = trainer_optimizer()
    dev = resolve_device(device)
    if spec.family == "lm":
        lib, step_fn = tf, make_lm_step(cfg, opt)
        batcher = pipe.lm_batcher(cfg.vocab_size, batch, seq, seed)
    elif spec.family == "recsys":
        lib, step_fn = rec_lib, make_recsys_step(cfg, opt)
        batcher = pipe.recsys_batcher(cfg.n_dense, cfg.n_sparse,
                                      cfg.rows_per_field, batch, seed)
    else:
        raise ValueError(f"train.py drives lm/recsys; got {spec.family}")

    def init_state():
        params = lib.init_params(cfg, seed, device=dev)
        return params, opt.init(params), torch.zeros((), dtype=torch.int32,
                                                     device=dev)

    ckpt = CheckpointManager(ckpt_dir, keep=2)
    return FaultTolerantTrainer(step_fn, init_state, batcher, ckpt,
                                ckpt_every=ckpt_every, device=dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject one failure at this step (chaos drill)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    trainer = build_trainer(args.arch, smoke=args.smoke,
                            ckpt_dir=args.ckpt_dir, device=args.device)
    fail = {args.fail_at: 1} if args.fail_at is not None else None
    rep = trainer.run(args.steps, fail_at=fail)
    print(f"steps={rep.steps_run} restarts={rep.restarts} "
          f"first_loss={rep.losses[0]:.4f} last_loss={rep.losses[-1]:.4f} "
          f"wall={rep.wall_s:.1f}s")


if __name__ == "__main__":
    main()
