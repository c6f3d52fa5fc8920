"""Port parity for the paper's benchmarks on the smoke substrate: the
Table-2 rows of ``repro_torch.benchmarks.table2.run_encoder`` against
the JAX ``benchmarks.table2.run_encoder`` (R*@1, R*@k, R@K, mRR@10 and
C equal), Figure 1 and the C(q) distribution against theirs, and the
port's substrate loader.

Both packages get the same arrays: one corpus from the shared generator,
the reference's index carried across by ``index_from_arrays``.  Neither
goes through its on-disk cache: each package's ``load_bench`` is
replaced by one that hands over that substrate, and both ``CACHE``
directories point at a temporary directory, so no test writes into
``artifacts/``.  Each side trains its own forests (the port's GBDT is a
copy, its features equal the reference's up to the last bits of the
score columns).
"""
import json

import numpy as np
import pytest

import jax.numpy as jnp

import benchmarks.clabel_dist as j_clabel_dist
import benchmarks.common as j_common
import benchmarks.figure1 as j_figure1
import benchmarks.table2 as j_table2
from repro.core import brute_force as j_brute_force
from repro.core import build_index as j_build_index
from repro.core.training import choose_n_probe as j_choose_n_probe
from repro.data.synthetic import clustered_corpus as j_clustered_corpus
from repro_torch.benchmarks import clabel_dist, common, figure1, table2
from repro_torch.core import index_from_arrays
from repro_torch.data.synthetic import (clustered_corpus,
                                        component_centers, query_mix)

ENC = "star-like"
METRICS = ("R*@1", "R*@k", "R@100", "mRR@10", "C")


@pytest.fixture(scope="module")
def substrate(tmp_path_factory):
    """The smoke substrate as a reference ``Bench`` and a port ``Bench``
    over the same arrays (the port's N and exact ids computed by the
    port)."""
    spread, hard = common.ENCODERS[ENC]
    corpus = clustered_corpus(
        n_docs=common.SMOKE_N_DOCS, dim=common.SMOKE_DIM,
        n_components=common.SMOKE_N_COMPONENTS,
        n_queries=common.SMOKE_N_QUERIES, spread=spread, hard_frac=hard,
        seed=common.encoder_seed(ENC))
    comps = common.SMOKE_N_COMPONENTS
    j_index = j_build_index(corpus.docs, comps, list_pad=256, n_iters=6,
                            seed=0)
    sp = common._splits(corpus.queries.shape[0], smoke=True)
    assert sp == j_common._splits(corpus.queries.shape[0], smoke=True)
    j_n = j_choose_n_probe(j_index, corpus.docs, corpus.queries[sp["valid"]],
                           rho=common.RHO, k=common.K, n_max=comps)
    j_exact = np.asarray(j_brute_force(jnp.asarray(corpus.docs),
                                       jnp.asarray(corpus.queries),
                                       common.K)[1])
    t_index = index_from_arrays(
        *(np.asarray(getattr(j_index, f)) for f in
          ("centroids", "docs", "doc_ids", "cluster_offsets",
           "cluster_sizes")), j_index.list_pad, device="cpu")
    t_bench = common.Bench(ENC, corpus, t_index, 0, None, sp)
    t_bench.n_probe = common.choose_n_probe(
        t_index, corpus.docs, corpus.queries[sp["valid"]], rho=common.RHO,
        k=common.K, n_max=comps)
    t_bench.exact_ids = common.exact_top_k(corpus.docs, corpus.queries,
                                           common.K, t_index.docs.device)
    j_bench = j_common.Bench(ENC, corpus, j_index, j_n, j_exact, sp)
    return j_bench, t_bench, tmp_path_factory.mktemp("bench_cache")


@pytest.fixture(scope="module")
def patched(substrate):
    """Both packages' ``load_bench`` hand over the substrate; both caches
    point at a temporary directory."""
    j_bench, t_bench, cache = substrate
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_common, "CACHE", str(cache))
        mp.setattr(common, "CACHE", str(cache))
        for mod in (j_table2, j_figure1, j_clabel_dist):
            mp.setattr(mod, "load_bench", lambda name, **kw: j_bench)
        for mod in (table2, figure1, clabel_dist):
            mp.setattr(mod, "load_bench", lambda name, **kw: t_bench)
        yield j_bench, t_bench


@pytest.fixture(scope="module")
def rows(patched):
    return (j_table2.run_encoder(ENC, smoke=True),
            table2.run_encoder(ENC, smoke=True, device="cpu"))


def test_substrate_n_probe_and_exact_ids_match_reference(substrate):
    j_bench, t_bench, _ = substrate
    assert t_bench.n_probe == j_bench.n_probe
    np.testing.assert_array_equal(t_bench.exact_ids, j_bench.exact_ids)


@pytest.mark.parametrize("i", range(8))
def test_table2_smoke_row_matches_reference(rows, i):
    want, got = rows[0][i], rows[1][i]
    assert got["strategy"] == want["strategy"]
    for m in METRICS:
        assert got[m] == want[m], (want["strategy"], m)
    assert got["T_ms"] > 0 and np.isfinite(got["Sp"])


def test_table2_learned_rows_stay_within_tau_and_n(rows, patched):
    n = patched[1].n_probe
    for r in rows[1][1:]:
        if r["strategy"].startswith("Patience"):
            continue
        assert common.TAU <= r["C"] <= n, r["strategy"]


def test_figure1_matches_reference(patched):
    want = j_figure1.main(ENC)
    got = figure1.main(ENC, device="cpu")
    assert got["h"] == want["h"]
    for key in ("mean", "exit", "cont"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)


def test_clabel_dist_matches_reference(patched):
    want = j_clabel_dist.main(ENC)
    got = clabel_dist.main(ENC, device="cpu")
    assert got.keys() == want.keys()
    for c in got:
        np.testing.assert_allclose(got[c], want[c], rtol=1e-9, err_msg=c)


def test_table2_main_writes_its_own_artifact(patched, tmp_path):
    out = tmp_path / "BENCH_table2_torch.json"
    got = table2.main(smoke=True, quick=True, device="cpu", out=str(out))
    saved = json.loads(out.read_text())
    assert saved["backend"] == "cpu" and "power_limit" in saved
    assert saved["device"] and saved["smoke"] and saved["quick"]
    assert [r["strategy"] for r in saved["rows"]] == \
        [r["strategy"] for r in got]
    assert len(got) == 8


def test_load_bench_seeds_stably_and_caches_its_own_files(tmp_path,
                                                          monkeypatch):
    """The port's corpus seed is a digest of the encoder's name, the
    same in every process; its cache holds ``.npz`` files named with it,
    and a second load reads them back to the same substrate."""
    import zlib
    assert common.encoder_seed(ENC) == zlib.crc32(ENC.encode()) % 2 ** 31
    monkeypatch.setattr(common, "CACHE", str(tmp_path))
    monkeypatch.setattr(common, "SMOKE_N_DOCS", 1500)
    monkeypatch.setattr(common, "SMOKE_N_QUERIES", 256)
    monkeypatch.setattr(common, "SMOKE_N_COMPONENTS", 16)
    first = common.load_bench(ENC, smoke=True, device="cpu")
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == [f"{ENC}_torch_{common.encoder_seed(ENC)}_smoke.npz"]
    again = common.load_bench(ENC, smoke=True, device="cpu")
    assert again.n_probe == first.n_probe
    np.testing.assert_array_equal(again.exact_ids, first.exact_ids)
    np.testing.assert_array_equal(again.corpus.queries, first.corpus.queries)
    np.testing.assert_array_equal(again.index.doc_ids.numpy(),
                                  first.index.doc_ids.numpy())


@pytest.mark.parametrize("kw", [
    dict(n_docs=3000, dim=16, n_components=40, n_queries=300, spread=0.3,
         hard_frac=0.4, seed=3),
    dict(n_docs=2000, dim=24, n_components=64, n_queries=128, seed=0)])
def test_clustered_corpus_matches_reference(kw):
    got, want = clustered_corpus(**kw), j_clustered_corpus(**kw)
    for f in ("docs", "queries", "relevant"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_query_mix_draws_more_queries_around_the_corpus_own_centres():
    """``component_centers`` are the centres the corpus was drawn
    around (its docs lie component by component, each nearest its own
    centre), and ``query_mix`` draws unit queries from them, the same
    for the same generator state."""
    kw = dict(n_docs=2000, dim=16, n_components=24, seed=7)
    corpus = clustered_corpus(n_queries=64, spread=0.02, **kw)
    centres = component_centers(**kw)
    home = np.argmax(corpus.docs @ centres.T, 1)
    assert np.all(np.diff(home) >= 0) and np.unique(home).size > 12

    def draw():
        return query_mix(np.random.default_rng(1), corpus.docs, centres,
                         100, spread=0.02, hard_frac=0.35)

    q = draw()
    assert q.shape == (100, 16) and q.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(q, draw())
    # the easy 65 are noisy copies of docs, the hard 35 lie between two
    # centres, far from every doc
    near_doc = (q @ corpus.docs.T).max(1) > 0.999
    assert near_doc.sum() == 65
