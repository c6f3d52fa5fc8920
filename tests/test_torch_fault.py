"""The port's fault-tolerant trainer, its training entry point and the
elastic restore (``repro_torch.runtime``, ``repro_torch.launch.train``)
on the CPU, against the uninterrupted run and the reference's trainer.

Tolerances: a restarted run's losses are the uninterrupted run's bit
for bit (deterministic steps, deterministic data).  Against the
reference's trainer on reduced StarCoder2 (the same initial weights,
carried by ``train_state_from_numpy``), each loss within rtol
``TRAJ_RTOL`` (1e-3: bf16 forwards on both sides, read at most 2.4e-5
over five steps), as ``loss_fn``'s own bound in tests/test_torch_train.py.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch, reduced
from repro_torch.data.pipeline import lm_batcher
from repro_torch.launch import train
from repro_torch.launch.mesh import launch
from repro_torch.models import transformer as ttf
from repro_torch.optim.optimizers import adafactor, sgdm
from repro_torch.runtime.elastic import elastic_restore, remesh
from repro_torch.runtime.fault import FaultTolerantTrainer, SimulatedFailure

TRAJ_RTOL = 1e-3
ARCH = "starcoder2-3b"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor ops: one intra-op thread (ROADMAP ground rules)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.launch import train as jtrain
    return types.SimpleNamespace(jax=jax, train=jtrain, Manager=JManager)


def _trainer(tmp, name, arch=ARCH, every=2):
    return train.build_trainer(arch, smoke=True, ckpt_dir=str(tmp / name),
                               ckpt_every=every, batch=4, seq=32,
                               device="cpu")


@pytest.mark.parametrize("arch,every,fail_at", [
    (ARCH, 2, {3: 1, 5: 1}),
    (ARCH, 4, {1: 1, 6: 2}),          # a failure before the first save
    ("deepfm", 2, {2: 1, 5: 1})])
def test_restart_trajectory_is_bit_for_bit(tmp_path, arch, every, fail_at):
    """Losses after crashes and restores == the uninterrupted run's, bit
    for bit; the update writes the state in place, so a failure before
    the first checkpoint starts again from a freshly built state."""
    ref_run = _trainer(tmp_path, "a", arch, every).run(8)
    faulty = _trainer(tmp_path, "b", arch, every).run(8, fail_at=fail_at)
    assert faulty.restarts == sum(fail_at.values())
    assert len(ref_run.losses) == 8
    assert faulty.losses == ref_run.losses
    assert faulty.steps_run > ref_run.steps_run


def test_too_many_failures_raise(tmp_path):
    with pytest.raises(SimulatedFailure):
        _trainer(tmp_path, "a").run(4, fail_at={1: 3}, max_restarts=2)


def test_trainer_matches_reference_trainer(ref, tmp_path):
    """Five steps of the port's trainer from the reference trainer's own
    initial state against the reference trainer's losses."""
    jtr = ref.train.build_trainer(ARCH, smoke=True,
                                  ckpt_dir=str(tmp_path / "j"),
                                  ckpt_every=2, batch=4, seq=32)
    state0 = ref.jax.tree.map(np.asarray, jtr.init_state)
    want = jtr.run(5).losses
    cfg = reduced(get_arch(ARCH)).model
    opt = train.trainer_optimizer()
    ttr = FaultTolerantTrainer(
        train.make_lm_step(cfg, opt),
        lambda: ttf.train_state_from_numpy(cfg, state0, device="cpu"),
        lm_batcher(cfg.vocab_size, 4, 32, 0),
        CheckpointManager(str(tmp_path / "t"), keep=2), ckpt_every=2)
    got = ttr.run(5).losses
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


def test_reference_checkpoint_resumes_in_the_port(ref, tmp_path):
    """A training checkpoint the reference's trainer wrote (step 4, layers
    stacked) restored by the port's manager, carried by
    ``train_state_from_numpy`` and trained on for steps 4 and 5: the
    reference's own losses at those steps."""
    jtr = ref.train.build_trainer(ARCH, smoke=True,
                                  ckpt_dir=str(tmp_path / "j"),
                                  ckpt_every=4, batch=4, seq=32)
    template = ref.jax.tree.map(np.asarray, jtr.init_state)
    want = jtr.run(6).losses
    step, tree = CheckpointManager(str(tmp_path / "j")).restore(
        template, step=4, device="cpu")
    assert step == 4
    cfg = reduced(get_arch(ARCH)).model
    state = ttf.train_state_from_numpy(cfg, tree, device="cpu")
    assert int(state[2]) == 4 and len(state[0]["layers"]) == cfg.n_layers
    step_fn = train.make_lm_step(cfg, train.trainer_optimizer())
    batcher = lm_batcher(cfg.vocab_size, 4, 32, 0)
    got = []
    for s in (4, 5):
        state, loss = step_fn(state, batcher.batch(s))
        got.append(float(loss))
    assert int(state[2]) == 6
    np.testing.assert_allclose(got, want[4:6], rtol=TRAJ_RTOL)


def test_train_state_from_numpy_unstacks_the_optimizer_state(ref):
    jax = ref.jax
    from repro.configs import get_arch as j_arch, reduced as j_reduced
    from repro.models import transformer as jtf
    from repro.optim import optimizers as jopt
    cfg = j_reduced(j_arch("deepseek-moe-16b")).model
    tcfg = reduced(get_arch("deepseek-moe-16b")).model
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    st = jopt.adamw(1e-3).init(params)
    st = jax.tree.map(lambda a: a + 1.5, st)
    tree = jax.tree.map(np.asarray, (params, st, np.int32(7)))
    p, opt, step = ttf.train_state_from_numpy(tcfg, tree, device="cpu")
    assert int(step) == 7 and step.dtype == torch.int32
    assert set(opt) == {"mu", "nu"} and "dense_layer_0" in opt["mu"]
    for i in range(len(p["layers"])):
        np.testing.assert_array_equal(
            opt["nu"]["layers"][i]["moe"]["wi"].numpy(),
            tree[1]["nu"]["layers"]["moe"]["wi"][i])
    tsg = jax.tree.map(np.asarray, jopt.sgdm(0.1).init(params))
    _, mom, _ = ttf.train_state_from_numpy(tcfg, (tree[0], tsg, 0),
                                           device="cpu")
    assert len(mom["layers"]) == tcfg.n_layers - 1
    fac = jax.tree.map(np.asarray, jopt.adafactor(0.1).init(params))
    with pytest.raises(ValueError, match="mirrors the params"):
        ttf.train_state_from_numpy(tcfg, (tree[0], fac, 0), device="cpu")
    # the port's own optimizer states have the params' layout
    assert adafactor(0.1).init(p)["layers"][0]["ln1"]["scale"].keys() == {"v"}
    assert sgdm(0.1).init(p)["embed"].shape == p["embed"].shape


def test_train_cli(tmp_path, capsys):
    train.main(["--smoke", "--steps", "6", "--ckpt-dir", str(tmp_path),
                "--fail-at", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("steps=9 restarts=1 first_loss=")
    with pytest.raises(ValueError, match="lm/recsys"):
        train.build_trainer("gat-cora", smoke=True, ckpt_dir=str(tmp_path),
                            device="cpu")


# -- elastic restore ---------------------------------------------------------

def _placements(mp_shard):
    from torch.distributed.tensor import Replicate, Shard
    return {"w": (Shard(0), Replicate()),
            "b": (Replicate(), Replicate()),
            "step": (Replicate(), Replicate()),
            "m": (Replicate(), Shard(1)) if mp_shard else
                 (Shard(1), Replicate())}


def _elastic_rank(rank, world, root, model_parallel):
    """Rank program: restore the checkpoint under ``root`` onto a
    (world / mp, mp) mesh; each leaf's local block and full tensor."""
    mesh = remesh(world, model_parallel=model_parallel)
    template = {"w": 0, "b": 0, "step": 0, "m": 0}
    step, tree = elastic_restore(CheckpointManager(root), template, mesh,
                                 _placements(model_parallel > 1))
    return step, tuple(mesh.shape), {
        k: (v.to_local().numpy(), v.full_tensor().numpy())
        for k, v in tree.items()}


def _arrays():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(8, 6)).astype(np.float32),
            "b": rng.normal(size=(6,)).astype(np.float32),
            "step": np.int32(12),
            "m": rng.normal(size=(3, 4)).astype(np.float32)}


@pytest.mark.parametrize("world,mp", [(1, 1), (2, 1), (2, 2)])
def test_elastic_restore_onto_another_mesh(tmp_path, world, mp):
    """A checkpoint written by one process restored onto a mesh of 1 and
    2 gloo ranks: every rank holds its block by its placements and the
    whole array back by ``full_tensor``."""
    arrays = _arrays()
    CheckpointManager(str(tmp_path), async_save=False).save(
        12, {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})
    outs = launch(_elastic_rank, world, str(tmp_path), mp, device="cpu",
                  timeout=60, deadline=180)
    for rank, (step, shape, tree) in enumerate(outs):
        assert step == 12 and shape == (world // mp, mp)
        d, m = rank // mp, rank % mp
        for k, (local, full) in tree.items():
            np.testing.assert_array_equal(full, arrays[k])
        rows = 8 // (world // mp)
        np.testing.assert_array_equal(tree["w"][0],
                                      arrays["w"][d * rows:(d + 1) * rows])
        np.testing.assert_array_equal(tree["b"][0], arrays["b"])
        cols = 4 // (mp if mp > 1 else world)
        idx = m if mp > 1 else d
        np.testing.assert_array_equal(
            tree["m"][0], arrays["m"][:, idx * cols:(idx + 1) * cols])


def test_remesh_checks_its_sizes():
    with pytest.raises(ValueError, match="divisible"):
        remesh(3, model_parallel=2)
