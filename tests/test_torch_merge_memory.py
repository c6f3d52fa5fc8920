"""A merge's device memory on the card: ``LiveIndex.merge_delta`` holds
the old index, the new one and one chunk of rows, and no gather of the
corpus.  It runs on the card without JAX:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_merge_memory.py
"""
import pytest
import torch

from repro_torch.index import LiveIndex, relayout
from repro_torch.index import live as live_mod

N_DOCS, DIM, LISTS = 1 << 20, 768, 8192


def _index_bytes(ix) -> int:
    return (ix.docs.numel() * ix.docs.element_size()
            + ix.doc_ids.numel() * ix.doc_ids.element_size())


@pytest.mark.gpu
def test_gpu_merge_holds_two_index_copies_and_one_chunk():
    """At 1,048,576 x 768, with 16,384 adds and 16,384 base deletes
    buffered: the merge's peak, less what the card held besides the
    index before it, stays within two index copies and one chunk of
    rows, plus 5% (the int64 columns over the rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    cents = torch.nn.functional.normalize(
        torch.randn(LISTS, DIM, generator=g, device=dev), dim=1)
    assign = torch.randint(LISTS, (N_DOCS,), generator=g, device=dev)
    vecs = cents[assign] + 0.1 * torch.randn(N_DOCS, DIM, generator=g,
                                             device=dev)
    ids = torch.arange(N_DOCS, dtype=torch.int32, device=dev)
    live = LiveIndex(relayout(vecs, ids, assign, cents, list_pad=256),
                     delta_cap=32768)
    del vecs, ids, assign
    live.add(cents[torch.randint(LISTS, (16384,), generator=g, device=dev)])
    live.delete(torch.randperm(N_DOCS, generator=g, device=dev)[:16384]
                .cpu().numpy())
    torch.cuda.synchronize(dev)
    old = _index_bytes(live.index)
    besides = torch.cuda.memory_allocated(dev) - old
    torch.cuda.reset_peak_memory_stats(dev)
    live.merge_delta()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - besides
    chunk = live_mod.RELAYOUT_CHUNK_ROWS * (DIM + 1) * 4
    bound = 1.05 * (old + _index_bytes(live.index) + chunk)
    assert peak <= bound, (peak, bound)
    assert len(live.delta) == 0 and live.n_live == N_DOCS
