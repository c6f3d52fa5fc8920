"""Fault-tolerant LM training drill: a reduced assigned-architecture LM
trains with async checkpoints while failures are injected; the loss
trajectory is bitwise identical to an uninterrupted run (port of
``examples/lm_fault_tolerant.py``).

    PYTHONPATH=src python -m repro_torch.examples.lm_fault_tolerant \
        --arch dbrx-132b [--device cpu]
"""
import argparse
import os
import shutil
import tempfile

import numpy as np

from repro_torch.launch.train import build_trainer


def main(*, arch="dbrx-132b", steps=30, fail_at=(7, 13), base=None,
         device=None):
    """Returns the two loss trajectories and the chaos run's restarts."""
    base = base or os.path.join(tempfile.gettempdir(),
                                f"repro_torch_ft_{arch}")
    for sub in ("a", "b"):
        shutil.rmtree(f"{base}/{sub}", ignore_errors=True)

    print(f"reference run ({arch} reduced, {steps} steps)...")
    ref = build_trainer(arch, smoke=True, ckpt_dir=f"{base}/a",
                        ckpt_every=5, device=device).run(steps)
    print(f"  losses: {ref.losses[0]:.4f} ... {ref.losses[-1]:.4f}")

    print(f"chaos run: injected failures at steps "
          f"{' and '.join(map(str, fail_at))}...")
    chaos = build_trainer(arch, smoke=True, ckpt_dir=f"{base}/b",
                          ckpt_every=5, device=device).run(
        steps, fail_at={s: 1 for s in fail_at})
    print(f"  restarts: {chaos.restarts}")
    np.testing.assert_array_equal(ref.losses, chaos.losses)
    print("  loss trajectory identical after restarts — "
          "checkpoint/restart + deterministic data replay verified.")
    return ref.losses, chaos.losses, chaos.restarts


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dbrx-132b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    a = ap.parse_args()
    main(arch=a.arch, steps=a.steps, device=a.device)
