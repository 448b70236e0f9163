"""The plain references against brute force at tiny sizes, and their
controls, which must come out not correct."""
import numpy as np
import pytest
import torch

from portbench import generate, harness
from portbench.entries import index as index_entry
from portbench.reference import suffix_order
from portbench.tests.conftest import SMALL_READS


def join(seqs) -> np.ndarray:
    """The rank text of sequences of any lengths, each followed by '$'."""
    return np.concatenate([np.append(s, np.uint8(0)) for s in seqs]).astype(np.uint8)


def brute_order(codes: np.ndarray) -> list:
    """Each suffix read to its sentinel, '$' below every base; equal ones by
    the sentinel's position."""
    ends = np.flatnonzero(codes == 0)

    def key(p):
        e = int(ends[np.searchsorted(ends, p)])
        return tuple(codes[p:e].tolist()) + (0,), e
    return sorted(range(codes.size), key=key)


def texts():
    rng = np.random.default_rng(7)
    yield "mixed lengths", join(
        [rng.integers(1, 5, int(rng.integers(1, 40))).astype(np.uint8) for _ in range(40)])
    yield "equal reads", join([np.array([1, 2, 1, 2, 1, 2], np.uint8)] * 9)
    yield "one symbol", join([np.array([3], np.uint8)])
    yield "reads of a small genome", generate.text(
        generate.reads({"genome_bp": 200, "depth": 8, "read_length": 60}, 3))


@pytest.mark.parametrize("label,codes", list(texts()), ids=[t[0] for t in texts()])
def test_suffix_order_is_the_brute_force_sort(label, codes):
    order = suffix_order.suffix_order(torch.from_numpy(codes)).numpy()
    assert order.tolist() == brute_order(codes)
    bwt, perm = suffix_order.bwt_perm(torch.from_numpy(codes), torch.from_numpy(order))
    prev = [0 if p == 0 else int(codes[p - 1]) for p in order.tolist()]
    assert bwt.tolist() == prev
    starts = np.concatenate(([0], np.flatnonzero(codes == 0)[:-1] + 1))
    read_of = {int(s): i for i, s in enumerate(starts)}
    assert perm.tolist() == [read_of[p] for p, c in zip(order.tolist(), prev) if c == 0]


def test_the_reference_index_is_the_ports():
    """At a tiny size the port's plain route and the reference agree."""
    from siga_tpu_torch.index import sa

    codes = generate.text(generate.reads(SMALL_READS, 12), reverse=True)
    bwt, perm = sa.bwt_perm_device(codes, "cpu")
    ref_bwt, ref_perm = suffix_order.index_arrays(torch.from_numpy(codes))
    assert np.array_equal(bwt, ref_bwt.numpy()) and np.array_equal(perm, ref_perm.numpy())


def test_the_index_control_is_not_correct():
    """The reference cut to the seed's 64 symbols, in the program's place."""
    cell = index_entry.Cell(SMALL_READS, harness.traffic("index"), 21, torch.device("cpu"), 1.0)
    readings = dict((n, v) for n, v, _limit in cell.control())
    assert readings["bwt_off"] > 0
