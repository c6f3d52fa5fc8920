"""Rows wider than a stage of the fused kernel's ring: an LLM embedder's
4,096-d rows (the benchmark's ``nq-e5-mistral``).

On the CPU: ``WaveScheduler.serve`` at d 4,096 on a tiny seeded corpus
against the benchmark's plain reference (``portbench/reference/
ivf_patience.py``, float64) on a fixture with no tie the two can part
at; the ring's layout (``kernels/ivf_scan_merge.py`` ``ring_layout``):
the stages of whole rows wherever two fit, as before slabs existed,
for every cell of the benchmark, and slabs of ``SLAB_COLS`` columns past
that width.

Marked ``gpu``: the fused kernel at d 1,536 (two stages of whole rows)
and 1,696, 3,584 and 4,096 (slabs) bit for bit against its own
unstaged path (the C entry called with no ring) and the per-probe pair
(``ivf_scan``, ``delta_scan``, ``topk_merge``), with and without the
delta stream, over list sizes that end in short tiles; on integer
inputs against the plain version; and the scheduler at d 4,096 against
fused ``search``.  The card's machine has no JAX:
``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_wide_rows.py``."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import corpus as corpus_mod  # noqa: E402
from portbench.reference import ivf_patience  # noqa: E402
from repro_torch.core.ivf import IVFIndex, search  # noqa: E402
from repro_torch.core.policies import patience  # noqa: E402
from repro_torch.core.serving import WaveScheduler  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import delta_scan as t_ds  # noqa: E402
from repro_torch.kernels import ivf_scan as t_scan  # noqa: E402
from repro_torch.kernels import ivf_scan_merge as t_sm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from test_torch_kernels import _delta_fused_inputs  # noqa: E402

# a tiny deployment at the embedder's width: 64 lists of at most 64 rows
WIDE = {
    "name": "tiny-wide", "n_docs": 2600, "dim": 4096,
    "metric": "inner_product", "n_lists": 64, "list_pad": 64, "align": 64,
    "n_probe": 32, "k": 100, "patience_delta": 7, "patience_phi": 95.0,
    "wave_size": 16, "chunk": 8,
    "corpus": {"spread_at_64": 0.25, "scale_range": [0.5, 1.5],
               "list_size_sigma": 0.35, "list_size_min": 1},
    "queries": {"hard_frac": 0.35, "easy_noise": 0.15}}
SEED = 7
POOL = 48
# the judge's tie_tol: a margin under it is a tie float32 may break
TIE = 1e-6
LIMIT = 232_448           # an H100's opt-in shared memory a block
WIDTHS = [1536, 1696, 3584, 4096]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wide(dev):
    c = corpus_mod.make(WIDE, POOL, SEED, dev)
    index = IVFIndex(c.centroids, c.docs, c.doc_ids, c.offsets, c.sizes,
                     c.list_pad)
    return c, index


def _knobs():
    return dict(wave_size=WIDE["wave_size"], chunk=WIDE["chunk"],
                k=WIDE["k"], n_probe=WIDE["n_probe"],
                delta=WIDE["patience_delta"], phi=WIDE["patience_phi"])


def _answers(rep):
    assert sorted(rep.results) == list(range(POOL))
    return (np.stack([rep.results[j] for j in range(POOL)]),
            np.array([rep.probes[j] for j in range(POOL)]))


def test_scheduler_at_4096_equals_plain_reference():
    """Every query's ids and probe count are the float64 reference's, and
    fused ``search``'s float32 scores lie within 1e-5 of its scores, on
    a corpus where no k-th-boundary margin up to a query's exit and no
    gap between neighbouring centroid scores through it is under
    ``TIE``."""
    c, index = _wide(torch.device("cpu"))
    kw = dict(k=WIDE["k"], n_probe=WIDE["n_probe"], list_pad=64)
    ref = ivf_patience.search(c.pool, c.docs, c.doc_ids, c.offsets,
                              c.sizes, c.centroids,
                              delta=WIDE["patience_delta"],
                              phi=WIDE["patience_phi"], **kw)
    mg = ivf_patience.margins(c.pool, c.docs, c.doc_ids, c.offsets,
                              c.sizes, c.centroids, **kw)
    probes = ref.probes.numpy()
    rows = np.arange(POOL)
    bnd, cen = mg.boundary.numpy(), mg.centroid.numpy()
    assert min(bnd[j, :probes[j]].min() for j in rows) > TIE
    assert min(cen[j, :probes[j] + 1].min() for j in rows) > TIE
    assert int(c.sizes.max()) <= 64 and len(set(probes.tolist())) > 5

    ids, got_probes = _answers(
        WaveScheduler(index, use_fused=True, **_knobs()).serve(c.pool))
    want_ids = ref.ids[rows, probes - 1].numpy()
    np.testing.assert_array_equal(got_probes, probes)
    np.testing.assert_array_equal(ids, want_ids)
    res = search(index, c.pool, patience(WIDE["n_probe"],
                                         WIDE["patience_delta"],
                                         WIDE["patience_phi"]),
                 use_fused_kernel=True, chunk=WIDE["chunk"])
    np.testing.assert_array_equal(res.topk_ids.numpy(), want_ids)
    np.testing.assert_allclose(res.topk_scores.double().numpy(),
                               ref.scores[rows, probes - 1].numpy(),
                               atol=1e-5, rtol=0)


# -- the ring's layout --------------------------------------------------------


def _whole_row_stages(d, k, chunk, list_pad, aligned, limit):
    """The ring's stages before slabs: whole rows only, 0 where two
    stages did not fit."""
    if d % 4 or not aligned:
        return 0
    for stages in range(t_sm.MAX_STAGES, 1, -1):
        if (stages * t_sm.TILE_ROWS * (d + 1) * 4 + 2 * k * 8
                + 16 * max(list_pad, t_sm.TILE_ROWS) + d * 4
                + 3 * t_sm.LIST * 4 + 5 * chunk * 4
                + t_sm.STATIC_SMEM) <= limit:
            return stages
    return 0


@pytest.mark.parametrize("d,k,chunk,want", [
    (96, 10, 8, (4, 96)),            # deep-bulk
    (768, 100, 8, (4, 768)),         # star-bulk, star-live, star-cascade
    (1536, 100, 8, (2, 1536)),
    (1536, 100, 4, (2, 1536)),
    (1692, 100, 4, (2, 1692)),       # the widest two whole rows hold
    (1696, 100, 8, (3, t_sm.SLAB_COLS)),
    (3584, 100, 8, (3, t_sm.SLAB_COLS)),
    (4096, 100, 8, (3, t_sm.SLAB_COLS)),   # nq-bulk
    (4096, 100, 4, (3, t_sm.SLAB_COLS)),
    (4098, 100, 8, (0, 4098)),       # rows not 16-byte aligned
], ids=lambda x: str(x))
def test_ring_layout(d, k, chunk, want):
    """Whole rows where two stages of them fit, slabs of SLAB_COLS
    columns past that, within the card's limit either way."""
    got = t_sm.ring_layout(d, k, chunk, 256, True, LIMIT)
    assert got == want
    assert t_sm.smem_bytes(d, k, chunk, 256, *got) + t_sm.STATIC_SMEM \
        <= LIMIT
    assert t_sm.ring_stages(d, k, chunk, 256, True, LIMIT) == want[0]
    assert t_sm.ring_layout(d, k, chunk, 256, False, LIMIT) == (0, d)


@pytest.mark.parametrize("k,chunk,list_pad", [(10, 8, 256), (100, 8, 256),
                                              (100, 4, 256), (1024, 8, 512)])
def test_whole_rows_wherever_two_stages_fit(k, chunk, list_pad):
    """At every width a multiple of 4 up to 8,192, the layout keeps the
    whole-row stages the ring took before slabs, and takes slabs only
    where it took none and d > SLAB_COLS."""
    for d in range(4, 8193, 4):
        old = _whole_row_stages(d, k, chunk, list_pad, True, LIMIT)
        stages, cols = t_sm.ring_layout(d, k, chunk, list_pad, True, LIMIT)
        if old:
            assert (stages, cols) == (old, d), d
        elif d > t_sm.SLAB_COLS:
            assert cols == t_sm.SLAB_COLS and stages >= 2, d
        else:
            assert (stages, cols) == (0, d), d


def test_benchmark_cells_keep_their_ring():
    """Each configuration of ``BENCHMARK.json`` at its own (d, k, chunk,
    list_pad): whole rows at the stages they had where they fit, slabs
    only for the 4,096-d rows."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    seen = {}
    for entry in bench["configs"]:
        cfg = json.loads((REPO / entry["file"]).read_text())
        shape = (cfg["dim"], cfg["k"], cfg["chunk"], cfg["list_pad"])
        layout = t_sm.ring_layout(*shape, True, LIMIT)
        old = _whole_row_stages(*shape, True, LIMIT)
        seen[entry["name"]] = layout
        if old:
            assert layout == (old, cfg["dim"]), entry["name"]
        else:
            assert layout[1] == t_sm.SLAB_COLS, entry["name"]
    assert seen["msmarco-star"] == (4, 768)
    assert seen["deep10m"] == (4, 96)
    assert seen["nq-e5-mistral"] == (3, t_sm.SLAB_COLS)


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda")


def _inputs(dev, d, integer=False):
    """``_delta_fused_inputs`` at width d, chunk 8, k 100, list sizes
    drawn in [0, 256] (short tail tiles), on the card: the kernel's
    arguments and its delta stream."""
    (qs, docs, ids, bo, sizes, rs, ri, dvecs, dids, dassign, gates, k, lp,
     chunk) = _delta_fused_inputs(seed=d, b=24, chunk=8, k=100, d=d,
                                  cap=300, integer=integer)
    if not integer:
        qs /= np.linalg.norm(qs, axis=1, keepdims=True)
        docs /= np.maximum(np.linalg.norm(docs, axis=1, keepdims=True), 1)
        dvecs /= np.linalg.norm(dvecs, axis=1, keepdims=True)
    assert (sizes % t_sm.TILE_ROWS != 0).mean() > 0.5
    to = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        qs, docs, ids.reshape(-1, 64), bo.reshape(-1), sizes.reshape(-1),
        rs, ri, dvecs, dids, dassign, gates.reshape(-1))]
    delta = dict(zip(("delta_vecs", "delta_ids", "delta_assign",
                      "gate_cids"), to[7:]))
    return to[:7], delta, dict(k=k, list_pad=lp, chunk=chunk, blk_l=64)


def _unstaged(args, delta, k, list_pad, chunk, blk_l):
    """The kernel with no ring (list rows read from global memory): its
    C entry called with 0 stages."""
    q = args[0]
    b, d = q.shape
    dev = q.device
    out_s = torch.empty((b, chunk, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, chunk, k), dtype=torch.int32, device=dev)
    cnt = torch.empty((b, chunk), dtype=torch.int32, device=dev)
    stream = [delta[n].data_ptr() if delta else None for n in (
        "delta_vecs", "delta_ids", "delta_assign", "gate_cids")]
    cap = delta["delta_vecs"].shape[0] if delta else 0
    _build.launch("ivf_scan_merge", dev, *(x.data_ptr() for x in args),
                  *stream, out_s.data_ptr(), out_i.data_ptr(),
                  cnt.data_ptr(), b, d, k, chunk, list_pad, blk_l, cap, 0,
                  d)
    return out_s, out_i, cnt


def _pair(args, delta, k, list_pad, chunk, blk_l):
    """The per-probe pair on the card a slot at a time: ``ivf_scan``'s
    list scores and ``delta_scan``'s gated buffer scores, one
    ``topk_merge`` into the running top-k (as
    ``test_ivf_scan_merge_delta_plain_matches_pair`` builds it)."""
    q, docs, ids2d, bo, sizes, run_s, run_i = args
    b = q.shape[0]
    bo, sizes = bo.view(b, chunk), sizes.view(b, chunk)
    ids = ids2d.reshape(-1)
    lane = torch.arange(list_pad, device=q.device)
    if delta:
        d_sc = t_ds.delta_scan(q, delta["delta_vecs"])
        gates = delta["gate_cids"].view(b, chunk)
    out_s, out_i = [], []
    for j in range(chunk):
        rows = bo[:, j].long()[:, None] * blk_l + lane
        li = ids[rows]
        alive = (lane < sizes[:, j:j + 1]) & (li >= 0)
        ns = torch.where(alive, t_scan.ivf_scan(
            q, docs, bo[:, j].contiguous(), list_pad=list_pad, blk_l=blk_l),
            float("-inf"))
        ni = torch.where(alive, li, -1)
        if delta:
            gate = (delta["delta_assign"][None] == gates[:, j:j + 1]) \
                & (delta["delta_ids"][None] >= 0)
            ns = torch.cat([ns, torch.where(gate, d_sc, float("-inf"))], 1)
            ni = torch.cat([ni, torch.where(
                gate, delta["delta_ids"][None], -1)], 1)
        run_s, run_i = tops.topk_merge(run_s, run_i, ns, ni, k)
        out_s.append(run_s)
        out_i.append(run_i)
    return torch.stack(out_s, 1), torch.stack(out_i, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("stream", ["list", "delta"])
@pytest.mark.parametrize("d", WIDTHS)
def test_gpu_wide_fused_equals_unstaged_and_pair(cuda, d, stream):
    """The wrapper's launch (whole rows at 1,536, slabs past it), counted
    as a ring launch, bit for bit its unstaged path and the per-probe
    pair, with and without the delta stream."""
    args, delta, kw = _inputs(cuda, d)
    delta = delta if stream == "delta" else {}
    layout = t_sm.ring_layout(d, kw["k"], kw["chunk"], kw["list_pad"], True,
                              _build.max_shared_optin(cuda))
    assert layout == ((2, d) if d == 1536 else (3, t_sm.SLAB_COLS))
    before = t_sm.ivf_scan_merge.ring_launches
    got = t_sm.ivf_scan_merge(*args, **kw, **delta)
    torch.cuda.synchronize()
    assert t_sm.ivf_scan_merge.ring_launches == before + 1
    for g, w in zip(got, _unstaged(args, delta, **kw)):
        assert torch.equal(g, w)
    want_s, want_i = _pair(args, delta, **kw)
    torch.cuda.synchronize()
    got_s = torch.where(got[0] > t_sm.VALID_MIN, got[0], float("-inf"))
    assert torch.equal(got[1], want_i)
    assert torch.equal(got_s, want_s)


@pytest.mark.gpu
@pytest.mark.parametrize("d", WIDTHS)
def test_gpu_wide_fused_integer_equals_plain(cuda, d):
    """On integer inputs every sum is exact: the kernel equals the plain
    version in scores, ids and counts, with and without the stream."""
    args, delta, kw = _inputs(cuda, d, integer=True)
    for stream in ({}, delta):
        got = t_sm.ivf_scan_merge(*args, **kw, **stream)
        want = t_sm.ivf_scan_merge_plain(*args, **kw, **stream)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.gpu
def test_gpu_scheduler_at_4096_equals_fused_search(cuda):
    """The scheduler's waves on the card (one ring launch a wave) answer
    every query with fused ``search``'s ids and probes."""
    c, index = _wide(cuda)
    sched = WaveScheduler(index, use_fused=True, **_knobs())
    rep = sched.serve(c.pool)
    ids, probes = _answers(rep)
    assert rep.ring_launches == rep.waves > 0
    res = search(index, c.pool, patience(WIDE["n_probe"],
                                         WIDE["patience_delta"],
                                         WIDE["patience_phi"]),
                 use_fused_kernel=True, chunk=WIDE["chunk"])
    np.testing.assert_array_equal(probes, res.probes.cpu().numpy())
    np.testing.assert_array_equal(ids, res.topk_ids.cpu().numpy())
