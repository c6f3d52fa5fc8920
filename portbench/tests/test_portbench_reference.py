"""The plain reference and the needed-work counts on a case worked out
by hand."""
import pytest
import torch

from portbench.reference import counts, ivf_patience

# three lists in 2-d, list_pad 4: list 0 at row 0 (2 live rows; row 2 a
# gap row, row 3 past the list's size), list 1 at row 4 (3 live), list 2
# at row 8 (1 live)
CENTROIDS = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]])
DOCS = torch.tensor([[0.9, 0.0], [0.1, 0.0], [5.0, 0.0], [5.0, 0.0],
                     [0.0, 1.0], [0.2, 0.2], [0.0, 0.1], [0.0, 0.0],
                     [-1.0, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]])
IDS = torch.tensor([10, 11, -1, 12, 20, 21, 22, -1, 30, -1, -1, -1],
                   dtype=torch.int32)
OFFSETS = torch.tensor([0, 4, 8], dtype=torch.int32)
SIZES = torch.tensor([2, 3, 1], dtype=torch.int32)
Q = torch.tensor([[1.0, 0.5]])    # sims 1, 0.5, -1: lists 0, 1, 2


def search(phi):
    return ivf_patience.search(Q, DOCS, IDS, OFFSETS, SIZES, CENTROIDS,
                               k=2, n_probe=3, delta=1, phi=phi,
                               list_pad=4)


@pytest.mark.parametrize("tf32", [False, True])
def test_patience_by_hand(tf32):
    """Probe 0 takes ids 10 (0.9) and 11 (0.1), masking the gap row and
    the row past the size (both 5.0).  Probe 1 brings 20 (0.5): the top-2
    is 10, 20; one of the two old entries kept, phi 50.  At Phi 50 the
    counter reaches Delta 1 there: 2 probes.  At Phi 60 it resets;
    probe 2 keeps both (phi 100) and the search ends at N = 3."""
    r = ivf_patience.search(Q, DOCS, IDS, OFFSETS, SIZES, CENTROIDS, k=2,
                            n_probe=3, delta=1, phi=50.0, list_pad=4,
                            tf32=tf32)
    assert r.order.tolist() == [[0, 1, 2]]
    assert r.probes.tolist() == [2]
    assert r.ids[0].tolist() == [[10, 11], [10, 20], [10, 20]]
    assert r.scores[0, 1].tolist() == pytest.approx([0.9, 0.5], abs=1e-3)
    assert search(60.0).probes.tolist() == [3]


def test_margins_by_hand():
    """With k 2 the boundary is the 2nd best less the 3rd: probe 0 has
    seen two documents (inf), probes 1 and 2 have 0.9, 0.5, 0.3 on top
    (0.2).  Centroid scores 1, 0.5, -1: gaps 0.5 and 1.5."""
    m = ivf_patience.margins(Q, DOCS, IDS, OFFSETS, SIZES, CENTROIDS, k=2,
                             n_probe=3, list_pad=4)
    assert m.boundary[0, 0] == float("inf")
    assert m.boundary[0, 1:].tolist() == pytest.approx([0.2, 0.2])
    assert m.centroid[0].tolist() == pytest.approx([0.5, 1.5])


def test_exact_ties_go_to_the_higher_id():
    r = ivf_patience._merge(torch.tensor([[1.0]], dtype=torch.float64),
                            torch.tensor([[4]]),
                            torch.tensor([[1.0, 2.0]], dtype=torch.float64),
                            torch.tensor([[9, 3]]), 2)
    assert r[1].tolist() == [[3, 9]] and r[2].tolist() == [[False, False]]


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12)])
    assert ivf_patience.round_tf32(x).tolist() == [
        1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0]


def test_doc_scores_are_float64_and_mask_empty_slots():
    id_rows = torch.full((31,), -1, dtype=torch.int64)
    id_rows[IDS[IDS >= 0].long()] = (IDS >= 0).nonzero()[:, 0]
    s = ivf_patience.doc_scores(Q, DOCS, id_rows, torch.tensor([[20, -1]]))
    assert s.dtype == torch.float64
    assert s.tolist() == [[0.5, float("-inf")]]


def test_counts_by_hand():
    cum = counts.live_rows_by_probes(Q, CENTROIDS, SIZES, 3)
    assert cum.tolist() == [[0, 2, 5, 6]]
    assert counts.scan_bytes(5, 2) == 5 * (4 * 2 + 4)
    assert counts.ranking_flops(3, 2, 3) == 2 * 2 * 3 * 3
    assert counts.table_bytes(3, 2) == 24
    assert counts.bound_s(counts.HBM_BYTES_PER_S, 1.0) == 1.0
    assert counts.bound_s(1.0, counts.F32_FLOPS_PER_S) == 1.0
