"""The cascade stage of a fused wave (``kernels/tau_stage.py``).

On the CPU the wrapper runs ``tau_stage_plain``, which must equal a
model written here bit for bit: each lane's RS_1 and history recorded
slot by slot in Python, then ``feature_matrix``, ``predict_margin`` and
the threshold.  A numpy model of the kernel's own steps (features read
where they lie, the walk, the leaves summed as a power-of-two pairwise
tree) must give ``predict_margin``'s margins bit for bit.  Tests marked
``gpu`` hold ``csrc/tau_stage.cu`` against ``tau_stage_plain`` on the
card, and a learned serve against fused ``search``; the file imports no
JAX, so the card runs them with
``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_tau_stage.py``.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.features import FeatureExtras, feature_matrix
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tau_stage as t_ts
from repro_torch.trees.torch_infer import ensemble_from_arrays, predict_margin

T = torch.from_numpy
REPO = Path(__file__).resolve().parents[1]
# the lane tensors in the wrapper's order, before the trees
FIELDS = ("snap_s", "snap_i", "cnts", "h", "active", "qvec",
          "centroid_sims", "rs1_ids", "phi_hist", "phi1_hist", "clf_exits",
          "lane_cap")
# values a guarded denominator takes near zero: 0, -0, inside and at eps
GUARD_EDGES = np.float32([0.0, -0.0, 5e-7, -5e-7, 1e-6, -1e-6, 2e-6, -2e-6])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda")


# -- a wave's inputs ----------------------------------------------------------

def lanes_case(w, chunk, k, d, tau, *, n_probe, seed, edge_frac=0.1):
    """A wave's lane inputs as numpy arrays: lanes fresh (h 0), before, at
    and past tau's slot, 15% inactive; snapshots of descending scores,
    30% with a tail of -inf (id -1) and some all -inf; ids from a pool of
    3k, so RS_1 and the snapshots overlap; ``edge_frac`` of the lanes
    with their first centroid sim and every snapshot's k-th score on a
    guard edge."""
    rng = np.random.default_rng([w, chunk, k, d, tau, n_probe, seed])
    hist_w = max(tau - 1, 1)
    s = -np.sort(-rng.normal(size=(w, chunk, k)), axis=-1).astype(np.float32)
    valid = np.where(rng.random((w, chunk)) < 0.3,
                     rng.integers(0, k + 1, (w, chunk)), k)
    s[np.arange(k)[None, None, :] >= valid[..., None]] = -np.inf
    ids = np.argsort(rng.random((w, chunk, 3 * k)), axis=-1)[..., :k]
    ids = np.where(np.isinf(s), -1, ids).astype(np.int32)
    rs1 = np.argsort(rng.random((w, 3 * k)), axis=-1)[:, :k]
    rs1 = np.where(rng.random((w, k)) < 0.2, -1, rs1).astype(np.int32)
    h = rng.integers(0, tau + chunk + 2, w)
    h[rng.random(w) < 0.25] = 0
    h[rng.random(w) < 0.3] = max(tau - 1 - rng.integers(0, chunk), 0)
    sims = rng.normal(size=(w, tau)).astype(np.float32)
    edge = rng.random(w) < edge_frac
    sims[edge, 0] = rng.choice(GUARD_EDGES, int(edge.sum()))
    s[edge, :, k - 1] = rng.choice(GUARD_EDGES, (int(edge.sum()), chunk))
    return dict(
        snap_s=s, snap_i=ids,
        cnts=rng.integers(0, k + 1, (w, chunk)).astype(np.int32),
        h=h.astype(np.int32), active=rng.random(w) < 0.85,
        qvec=rng.normal(size=(w, d)).astype(np.float32),
        centroid_sims=sims, rs1_ids=rs1,
        phi_hist=(100 * rng.random((w, hist_w))).astype(np.float32),
        phi1_hist=(100 * rng.random((w, hist_w))).astype(np.float32),
        clf_exits=np.int64(7),
        lane_cap=rng.integers(tau + 1, 81, w).astype(np.int32))


def pct(n: int, k: int) -> torch.Tensor:
    """100 n / k as the chain computes it for one count."""
    return (100.0 * torch.tensor([n], dtype=torch.float32) / k)[0]


def history_model(c, *, tau, k, chunk, n_probe):
    """RS_1 and the two history rows, lane by lane and probe by probe:
    probe p (2..tau) is recorded from the slot that merged it this wave;
    the share of RS_1 kept counts the pairs of equal ids, RS_1's -1 never
    counting."""
    rs1, phi, phi1 = (c[n].copy() for n in ("rs1_ids", "phi_hist",
                                            "phi1_hist"))
    phi, phi1 = T(phi), T(phi1)
    for lane in range(c["h"].shape[0]):
        h, act = int(c["h"][lane]), bool(c["active"][lane])

        def merged(t):
            return act and 0 <= t < chunk and h + t < n_probe

        if merged(0) and h == 0:
            rs1[lane] = c["snap_i"][lane, 0]
        for probe in range(2, tau + 1):
            t = probe - 1 - h
            if not merged(t):
                continue
            ids = c["snap_i"][lane, t]
            kept = sum(int((ids == r).sum()) for r in rs1[lane] if r >= 0)
            phi[lane, probe - 2] = pct(k - int(c["cnts"][lane, t]), k)
            phi1[lane, probe - 2] = pct(kept, k)
    return T(rs1), phi, phi1


def features(c, rs1_phi_phi1, *, tau, chunk):
    """The Table-1 matrix of every lane at its tau slot (the slot clamped
    into the chunk where tau is elsewhere) and the lanes at tau."""
    _, phi, phi1 = rs1_phi_phi1
    h = c["h"].astype(np.int64)
    t_tau = tau - 1 - h
    stage = c["active"] & (t_tau >= 0) & (t_tau < chunk)
    scores = c["snap_s"][np.arange(h.shape[0]), np.clip(t_tau, 0, chunk - 1)]
    fm = feature_matrix(FeatureExtras(
        queries=T(c["qvec"]), centroid_sims=T(c["centroid_sims"]),
        topk_scores=T(np.ascontiguousarray(scores)), phi_hist=phi,
        phi1_hist=phi1), with_intersections=True)
    return fm, stage


def forest(c, fm, stage, *, n_trees, depth, seed, zero_leaves=0.1):
    """Trees of ``depth`` whose splits read every feature group, at a
    threshold equal to some lane's feature (one in three moved an ulp
    down or up); 15% of the inner nodes below the root are leaves,
    ``zero_leaves`` of the leaves -0.0; the base puts half the stage
    lanes' margins on each side of 0."""
    rng = np.random.default_rng([n_trees, depth, seed])
    w, f_all = fm.shape
    d, tau = c["qvec"].shape[1], c["centroid_sims"].shape[1]
    groups = [(0, d), (d, d + tau), (d + tau, d + tau + 4),
              (d + tau + 4, f_all)]
    m = 2 ** (depth + 1) - 1
    feat = np.full((n_trees, m), -1, np.int32)
    thr = np.zeros((n_trees, m), np.float32)
    left = np.tile(np.arange(m, dtype=np.int32), (n_trees, 1))
    right = left.copy()
    value = np.zeros((n_trees, m), np.float32)
    fmn = fm.numpy()
    for t in range(n_trees):
        for node in range(m):
            level = int(np.log2(node + 1))
            if level < depth and (level == 0 or rng.random() < 0.85):
                lo, hi = groups[rng.choice(4, p=[0.25, 0.2, 0.3, 0.25])]
                f = int(rng.integers(lo, hi))
                x = fmn[int(rng.integers(w)), f]
                feat[t, node] = f
                thr[t, node] = np.nextafter(
                    x, [np.float32(-np.inf), x, np.float32(np.inf)][
                        rng.integers(3)]).astype(np.float32)
                left[t, node], right[t, node] = 2 * node + 1, 2 * node + 2
            else:
                value[t, node] = np.float32(-0.0) if \
                    rng.random() < zero_leaves else \
                    np.float32(0.5 * rng.normal())
    raw = predict_margin(ensemble_from_arrays(
        feat, thr, left, right, value, 0.0, depth, device="cpu"), fm)
    base = -np.median(raw.numpy()[stage]) if stage.any() else 0.0
    return feat, thr, left, right, value, np.float32(base), depth


def stage_case(w, chunk, k, d, tau, *, n_probe, n_trees, depth, seed,
               threshold=0.5, edge_frac=0.1, zero_leaves=0.1):
    c = lanes_case(w, chunk, k, d, tau, n_probe=n_probe, seed=seed,
                   edge_frac=edge_frac)
    fm, stage = features(c, history_model(c, tau=tau, k=k, chunk=chunk,
                                          n_probe=n_probe),
                         tau=tau, chunk=chunk)
    c["trees"] = forest(c, fm, stage, n_trees=n_trees, depth=depth,
                        seed=seed, zero_leaves=zero_leaves)
    c["kw"] = dict(tau=tau, k=k, chunk=chunk, n_probe=n_probe,
                   threshold=threshold)
    return c


def stage_args(c, dev="cpu"):
    """(the lane tensors in ``FIELDS`` order, the trees) on ``dev``."""
    lanes = [torch.tensor(np.asarray(c[n])).to(dev) for n in FIELDS]
    return lanes, ensemble_from_arrays(*c["trees"], device=dev)


def fresh(lanes):
    """Copies: the stage counts its exits into ``clf_exits`` in place."""
    return [t.clone() for t in lanes]


def stage_model(c):
    """The stage from the history model, ``feature_matrix`` and
    ``predict_margin``: (RS_1, phi, phi1, exits, caps)."""
    kw = c["kw"]
    hist = history_model(c, tau=kw["tau"], k=kw["k"], chunk=kw["chunk"],
                         n_probe=kw["n_probe"])
    fm, stage = features(c, hist, tau=kw["tau"], chunk=kw["chunk"])
    _, clf = stage_args(c)
    says = (torch.sigmoid(predict_margin(clf, fm))
            >= kw["threshold"]).numpy()
    exits = stage & says
    return (*hist, torch.tensor(int(c["clf_exits"]) + int(exits.sum())),
            T(np.where(exits, kw["tau"], c["lane_cap"]).astype(np.int32)))


def assert_same_bits(got, want):
    for name, g, x in zip(t_ts.TauStageOut._fields, got, want):
        g, x = g.cpu(), x.cpu()
        assert g.dtype == x.dtype and g.shape == x.shape, name
        if g.dtype == torch.float32:
            g, x = g.view(torch.int32), x.view(torch.int32)
        assert torch.equal(g, x), name


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("tau", [1, 2, 4, 10])
@pytest.mark.parametrize("chunk", [1, 4, 8])
@pytest.mark.parametrize("budget", ["wide", "tight"])
def test_tau_stage_plain_is_the_model(tau, chunk, budget):
    """The wrapper's CPU route (``tau_stage_plain``, also through
    ``ops``) equals the lane-by-lane model bit for bit, counts the exits
    into ``clf_exits`` in place and launches nothing.  The tight budget
    puts slots of the chunk past ``n_probe``."""
    n_probe = tau + chunk if budget == "wide" else max(1, tau // 2)
    c = stage_case(48, chunk, 12, 6, tau, n_probe=n_probe,
                   n_trees={1: 5, 4: 9, 8: 33}[chunk], depth=4,
                   seed=tau * 10 + chunk)
    want = stage_model(c)
    lanes, clf = stage_args(c)
    before = t_ts.tau_stage.launches
    for fn in (t_ts.tau_stage, tops.tau_stage, t_ts.tau_stage_plain):
        args = fresh(lanes)
        got = fn(*args, clf, **c["kw"])
        assert got.clf_exits is args[FIELDS.index("clf_exits")]
        assert_same_bits(got, want)
    assert t_ts.tau_stage.launches == before
    # the case reaches what it is for
    h, act = c["h"], c["active"]
    t_tau = tau - 1 - h
    stage = act & (t_tau >= 0) & (t_tau < chunk)
    exits = int(want[3]) - int(c["clf_exits"])
    assert 0 < exits < stage.sum()
    assert (act & (h == 0)).any()
    if tau > 1 and n_probe > 1:
        written = ~np.equal(want[1].numpy(), c["phi_hist"])
        assert written.any()


def kernel_walk_model(c, hist, lanes_at):
    """csrc/tau_stage.cu's stage for the lanes ``lanes_at``, in numpy
    float32, from the recorded history ``hist`` (RS_1, phi, phi1): every
    feature read where it lies, the walk stopped at a leaf, the leaves
    padded with +0.0 to a power of two and added in pairs level by
    level, then base: (the margins, the features read)."""
    feat, thr, left, right, value, base, depth = c["trees"]
    kw = c["kw"]
    tau, k = kw["tau"], kw["k"]
    d = c["qvec"].shape[1]
    rows = np.concatenate([hist[1].numpy(), hist[2].numpy()], axis=1)
    eps, pct_f, f32 = np.float32(1e-6), np.float32(0.01), np.float32

    def finite(x):
        return x if np.isfinite(x) else f32(0.0)

    def guard(x):
        if abs(x) > eps:
            return x
        return f32(f32(np.sign(x) if x == x else 0.0) * eps) + eps

    margins, read = [], []
    with np.errstate(divide="ignore", invalid="ignore"):
        for lane in lanes_at:
            t_tau = tau - 1 - int(c["h"][lane])
            sc = c["snap_s"][lane, t_tau]
            s1, sk = finite(sc[0]), finite(sc[k - 1])
            cs = c["centroid_sims"][lane]
            g3 = [s1, sk, f32(s1 / guard(sk)), f32(s1 / guard(cs[0]))]

            def x_of(f):
                if f < d:
                    return c["qvec"][lane, f]
                if f - d < tau:
                    return cs[f - d]
                if f - d - tau < 4:
                    return g3[f - d - tau]
                return f32(rows[lane, f - d - tau - 4] * pct_f)

            read.append([x_of(f) for f in range(d + tau + 4 +
                                                 rows.shape[1])])
            leaves = []
            for t in range(feat.shape[0]):
                node = 0
                for _ in range(depth):
                    f = int(feat[t, node])
                    if f < 0:
                        break
                    node = int(left[t, node] if x_of(f) <= thr[t, node]
                               else right[t, node])
                leaves.append(value[t, node])
            p = 1 << (len(leaves) - 1).bit_length()
            sums = np.array(leaves + [f32(0.0)] * (p - len(leaves)), f32)
            while sums.shape[0] > 1:
                sums = (sums[0::2] + sums[1::2]).astype(f32)
            margins.append(f32(sums[0] + base))
    return np.array(margins, np.float32), np.array(read, np.float32)


@pytest.mark.parametrize("tau", [1, 2, 4, 10])
@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_kernel_walk_model_is_predict_margin(tau, chunk):
    """The kernel's walk and leaf sum, modelled in numpy, give
    ``predict_margin``'s margins bit for bit on the lanes at tau, and the
    features it reads where they lie are the matrix's (group 3 computed
    from the snapshot, the guard on its edges); odd and even tree counts,
    1 to 33, with -0.0 leaves."""
    c = stage_case(40, chunk, 10, 5, tau, n_probe=tau + chunk,
                   n_trees=[1, 2, 7, 33][[1, 2, 4, 10].index(tau)], depth=4,
                   seed=100 + tau * 10 + chunk, edge_frac=0.4,
                   zero_leaves=0.3)
    kw = c["kw"]
    hist = history_model(c, tau=tau, k=kw["k"], chunk=chunk,
                         n_probe=kw["n_probe"])
    fm, stage = features(c, hist, tau=tau, chunk=chunk)
    lanes_at = np.nonzero(stage)[0]
    assert lanes_at.size > 4
    margins, read = kernel_walk_model(c, hist, lanes_at)
    _, clf = stage_args(c)
    want = predict_margin(clf, fm).numpy()[lanes_at]
    np.testing.assert_array_equal(margins.view(np.int32),
                                  want.view(np.int32))
    # group 3 as the kernel computes it, the guard's edges included
    d = c["qvec"].shape[1]
    g3 = slice(d + tau, d + tau + 4)
    np.testing.assert_array_equal(read[:, g3].view(np.int32),
                                  fm.numpy()[lanes_at, g3].view(np.int32))
    np.testing.assert_array_equal(read.view(np.int32),
                                  fm.numpy()[lanes_at].view(np.int32))


@pytest.mark.parametrize("bad", [
    "snap_f64", "ids_i64", "cnts_i64", "h_i64", "active_i32", "exits_i32",
    "cap_i64", "qvec_1d", "sims_not_tau", "rs1_short", "hist_wide",
    "k_disagrees", "chunk_disagrees", "lanes_disagree", "tau_zero",
    "n_probe_zero", "k_zero", "no_trees", "depth_negative", "feat_i64",
    "base_1d", "strided", "mixed_devices", "meta", "feat_past_layout"])
def test_tau_stage_wrapper_raises(bad):
    """The wrapper refuses what the kernel does not take: types, shapes,
    knobs, strides, devices and trees that split past the Table-1
    layout."""
    c = stage_case(16, 4, 6, 3, 4, n_probe=8, n_trees=3, depth=2, seed=1)
    lanes, clf = stage_args(c)
    a = dict(zip(FIELDS, lanes))
    kw = dict(c["kw"])
    if bad == "snap_f64":
        a["snap_s"] = a["snap_s"].double()
    elif bad == "ids_i64":
        a["snap_i"] = a["snap_i"].long()
    elif bad == "cnts_i64":
        a["cnts"] = a["cnts"].long()
    elif bad == "h_i64":
        a["h"] = a["h"].long()
    elif bad == "active_i32":
        a["active"] = a["active"].int()
    elif bad == "exits_i32":
        a["clf_exits"] = a["clf_exits"].int()
    elif bad == "cap_i64":
        a["lane_cap"] = a["lane_cap"].long()
    elif bad == "qvec_1d":
        a["qvec"] = a["qvec"][:, 0]
    elif bad == "sims_not_tau":
        a["centroid_sims"] = a["centroid_sims"][:, :3]
    elif bad == "rs1_short":
        a["rs1_ids"] = a["rs1_ids"][:, :5]
    elif bad == "hist_wide":
        a["phi_hist"] = torch.zeros((16, 4))
    elif bad == "k_disagrees":
        kw["k"] = 5
    elif bad == "chunk_disagrees":
        kw["chunk"] = 8
    elif bad == "lanes_disagree":
        a["h"] = a["h"][:15]
    elif bad in ("tau_zero", "n_probe_zero", "k_zero"):
        kw[bad[:-5]] = 0
    elif bad == "no_trees":
        clf.feat = clf.feat[:0]
    elif bad == "depth_negative":
        clf.max_depth = -1
    elif bad == "feat_i64":
        clf.feat = clf.feat.long()
    elif bad == "base_1d":
        clf.base = clf.base.reshape(1)
    elif bad == "strided":
        a["snap_s"] = a["snap_s"].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "mixed_devices":
        clf.value = clf.value.to("meta")
    elif bad == "feat_past_layout":
        # d 3, tau 4: 3 + 4 + 4 + 2 * 3 = 17 columns; the root reads 17
        clf.feat = clf.feat.clone()
        clf.feat[0, 0] = 17
    else:
        a = {n: t.to("meta") for n, t in a.items()}
        clf.__dict__.update({n: getattr(clf, n).to("meta") for n in (
            "feat", "thresh", "left", "right", "value", "base")})
    with pytest.raises(ValueError, match="tau_stage: a tree splits on "
                       "feature 17, past the 17" if bad == "feat_past_layout"
                       else "tau_stage"):
        t_ts.tau_stage(*(a[n] for n in FIELDS), clf, **kw)


def test_scheduler_refuses_trees_past_the_layout():
    """The kernel reads a feature where it lies, so the scheduler refuses
    trees that split on a feature past the Table-1 layout of its
    queries' width and tau."""
    from repro_torch.core.ivf import build_index
    from repro_torch.core.policies import cascade_patience
    from repro_torch.core.serving import WaveScheduler

    rng = np.random.default_rng(3)
    docs = rng.normal(size=(512, 8)).astype(np.float32)
    index = build_index(T(docs), 8, list_pad=128, n_iters=2, seed=0,
                        device="cpu")
    n_feat = 8 + 4 + 4 + 2 * 3
    for f, ok in ((n_feat - 1, True), (n_feat, False)):
        clf = ensemble_from_arrays(
            np.int32([[f, -1, -1]]), np.float32([[0.0, 0.0, 0.0]]),
            np.int32([[1, 1, 2]]), np.int32([[2, 1, 2]]),
            np.float32([[0.0, 1.0, -1.0]]), 0.0, 1, device="cpu")
        pol = cascade_patience(6, clf, 3, tau=4, k=5)
        if ok:
            WaveScheduler(index, policy=pol, wave_size=8, chunk=4)
        else:
            with pytest.raises(ValueError, match="past the 22 Table-1"):
                WaveScheduler(index, policy=pol, wave_size=8, chunk=4)


# -- on the card --------------------------------------------------------------

GPU_CASES = {
    # the benchmark's wave: 1,024 lanes, chunk 8, k 100, d 768, tau 10,
    # 100 trees of depth 6
    "cell": dict(w=1024, chunk=8, k=100, d=768, tau=10, n_probe=80,
                 n_trees=100, depth=6),
    "odd_trees": dict(w=256, chunk=8, k=100, d=64, tau=10, n_probe=80,
                      n_trees=99, depth=6),
    "guard": dict(w=256, chunk=8, k=100, d=32, tau=10, n_probe=80,
                  n_trees=64, depth=6, edge_frac=0.8),
    "zero_leaves": dict(w=256, chunk=4, k=10, d=16, tau=4, n_probe=16,
                        n_trees=33, depth=4, zero_leaves=0.7),
    "tau1": dict(w=256, chunk=4, k=100, d=32, tau=1, n_probe=16,
                 n_trees=17, depth=6),
    "tau2": dict(w=256, chunk=8, k=100, d=32, tau=2, n_probe=16,
                 n_trees=17, depth=6),
    "chunk1": dict(w=256, chunk=1, k=100, d=32, tau=10, n_probe=80,
                   n_trees=100, depth=6),
    "k1": dict(w=256, chunk=4, k=1, d=32, tau=4, n_probe=16, n_trees=5,
               depth=3),
    "tight_budget": dict(w=256, chunk=8, k=100, d=32, tau=10, n_probe=5,
                         n_trees=40, depth=6),
    "k_over_128": dict(w=128, chunk=4, k=200, d=32, tau=6, n_probe=16,
                       n_trees=300, depth=5),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_gpu_tau_stage_matches_plain(cuda, case):
    """The kernel against ``tau_stage_plain`` on the same CUDA tensors,
    bit for bit on RS_1, both history rows, the caps and the exit count,
    one launch a call; splits sit on lanes' own feature values."""
    spec = dict(GPU_CASES[case])
    w, chunk, k, d, tau = (spec.pop(n) for n in ("w", "chunk", "k", "d",
                                                  "tau"))
    c = stage_case(w, chunk, k, d, tau, seed=5, **spec)
    lanes, clf = stage_args(c, cuda)
    want = t_ts.tau_stage_plain(*fresh(lanes), clf, **c["kw"])
    before = t_ts.tau_stage.launches
    got = tops.tau_stage(*fresh(lanes), clf, **c["kw"])
    torch.cuda.synchronize()
    assert t_ts.tau_stage.launches == before + 1
    assert_same_bits(got, want)
    exits = int(want.clf_exits) - int(c["clf_exits"])
    assert exits > 0 and (want.lane_cap != lanes[-1]).sum() == exits


def threshold_case(threshold: float, seed: int):
    """1,024 lanes at tau (tau 1, h 0), each reading its own margin
    through one tree that sorts the lanes by their first query value: 256
    margins an ulp apart around the threshold's logit, 256 2^-27 apart
    around it, 512 drawn around it."""
    rng = np.random.default_rng(seed)
    w, depth = 1024, 10
    logit = np.float32(np.log(threshold / (1.0 - threshold)))
    near = [logit]
    for to in (np.float32(np.inf), np.float32(-np.inf)):
        x = logit
        for _ in range(128 if to < 0 else 127):
            x = np.nextafter(x, to)
            near.append(x)
    margins = np.concatenate([
        np.sort(np.array(near, np.float32)),
        logit + np.float32(2.0 ** -27) * np.arange(-128, 128,
                                                    dtype=np.float32),
        logit + rng.normal(size=512).astype(np.float32) * np.float32(3.0)
    ]).astype(np.float32)
    m = 2 ** (depth + 1) - 1
    feat = np.full(m, -1, np.int32)
    thr = np.zeros(m, np.float32)
    left = np.arange(m, dtype=np.int32)
    right = left.copy()
    value = np.zeros(m, np.float32)
    for node in range(m):
        level = int(np.log2(node + 1))
        if level < depth:
            span = 2 ** (depth - level)
            lo = (node - (2 ** level - 1)) * span
            feat[node], thr[node] = 0, lo + span // 2 - 0.5
            left[node], right[node] = 2 * node + 1, 2 * node + 2
        else:
            value[node] = margins[node - (2 ** depth - 1)]
    c = lanes_case(w, 1, 10, 4, 1, n_probe=8, seed=seed, edge_frac=0.0)
    c["h"][:] = 0
    c["active"][:] = True
    c["qvec"][:, 0] = np.arange(w, dtype=np.float32)
    c["trees"] = (feat[None], thr[None], left[None], right[None],
                  value[None], np.float32(0.0), depth)
    c["kw"] = dict(tau=1, k=10, chunk=1, n_probe=8, threshold=threshold)
    return c


@pytest.mark.gpu
@pytest.mark.parametrize("threshold", [0.5, 0.3, 0.9, 0.999])
def test_gpu_tau_stage_exit_at_the_threshold(cuda, threshold):
    """Margins within ulps of the threshold's logit: the kernel's sigmoid
    and compare exit exactly the lanes PyTorch's CUDA sigmoid does."""
    c = threshold_case(threshold, seed=int(threshold * 1000))
    lanes, clf = stage_args(c, cuda)
    want = t_ts.tau_stage_plain(*fresh(lanes), clf, **c["kw"])
    got = tops.tau_stage(*fresh(lanes), clf, **c["kw"])
    torch.cuda.synchronize()
    assert_same_bits(got, want)
    exits = int(want.clf_exits) - int(c["clf_exits"])
    assert 0 < exits < 1024


TINY = {
    "name": "tiny-cascade", "n_docs": 3000, "dim": 32,
    "metric": "inner_product", "n_lists": 64, "list_pad": 64, "align": 64,
    "n_probe": 16, "k": 10, "patience_delta": 3, "patience_phi": 90.0,
    "wave_size": 32, "chunk": 8,
    "corpus": {"spread_at_64": 0.3, "scale_range": [0.5, 1.5],
               "list_size_sigma": 0.35, "list_size_min": 1},
    "queries": {"hard_frac": 0.8, "easy_noise": 0.15},
    "reference": "portbench/reference/ivf_cascade.py",
    "check": {"sample": 4096, "longest": 32, "gap_tol": 1e-5,
              "tie_tol": 1e-6, "tree_tol": 1e-5,
              "limits": {"missing": 0, "inputs_changed": 0, "invalid": 0,
                         "exit_mismatch_pct": 0.25, "gap_share_pct": 0.2}},
    "policy": {"kind": "cascade_patience", "tau": 10, "clf_threshold": 0.5,
               "exit_weight": 3.0,
               "train": {"queries": 512, "valid": 128, "n_trees": 30,
                         "max_depth": 4, "n_bins": 32}}}


@pytest.mark.gpu
def test_gpu_cascade_serve_runs_the_kernel(cuda, monkeypatch):
    """A learned serve on the card launches ``tau_stage`` once a fused
    wave and never runs the plain chain, and answers as fused ``search``
    does under the same policy: ids, probes and the classifier's exits."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from portbench import corpus as corpus_mod
    from portbench import harness, policy
    from repro_torch.core.ivf import IVFIndex, search
    from repro_torch.core.serving import WaveScheduler

    seed, n = 2**31 + 36, 160
    c = corpus_mod.make(TINY, n, seed, cuda)
    index = IVFIndex(c.centroids, c.docs, c.doc_ids, c.offsets, c.sizes,
                     c.list_pad)
    pol = harness.program_policy(policy.train(c, TINY, seed)[0], TINY, cuda)

    def refuse(*args, **kw):
        raise AssertionError("the plain chain ran on the card")

    monkeypatch.setattr(t_ts, "tau_stage_plain", refuse)
    before = t_ts.tau_stage.launches
    rep = WaveScheduler(index, policy=pol, wave_size=TINY["wave_size"],
                        chunk=TINY["chunk"]).serve(c.pool)
    assert t_ts.tau_stage.launches - before == rep.waves > 0
    res = search(index, c.pool, pol, use_fused_kernel=True,
                 chunk=TINY["chunk"])
    assert sorted(rep.results) == list(range(n))
    np.testing.assert_array_equal(
        np.stack([rep.results[j] for j in range(n)]),
        res.topk_ids.cpu().numpy())
    np.testing.assert_array_equal([rep.probes[j] for j in range(n)],
                                  res.probes.cpu().numpy())
    says = (torch.sigmoid(predict_margin(pol.clf, res.features))
            >= pol.clf_threshold)
    assert rep.clf_exits == int(says.sum()) > 0
