"""The port's Smith-Waterman wavefront against the JAX package and the naive
DP.  Scores and end positions are integers: equality is exact."""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siga_tpu.core import dna
from siga_tpu.ops.sw_device import _sw_wavefront
from siga_tpu_torch.ops.sw import (EDGE_PARAMS, STRIP_ROWS, BatchAligner, sw_edge_cases,
                                   sw_strips, sw_wavefront_plain)

from test_align import naive_best_score

PARAMS = (2, 2, 3, 1)


def _pairs(seed):
    rng = random.Random(seed)
    queries, refs = [], []
    for _ in range(16):
        q = "".join(rng.choice("ACGT") for _ in range(rng.randint(8, 20)))
        r = "".join(rng.choice("ACGT") for _ in range(rng.randint(10, 40)))
        if rng.random() < 0.5:
            pos = rng.randint(0, len(r) - 1)
            mq = list(q)
            if len(mq) > 3:
                mq[rng.randint(0, len(mq) - 1)] = rng.choice("ACGT")
            r = r[:pos] + "".join(mq) + r[pos:]
        queries.append(q)
        refs.append(r)
    return queries, refs


def _jax_scores(queries, refs):
    qm = np.zeros((len(queries), max(map(len, queries))), dtype=np.int32)
    rm = np.zeros((len(refs), max(map(len, refs))), dtype=np.int32)
    for i, (q, r) in enumerate(zip(queries, refs)):
        qm[i, : len(q)] = dna.encode(q)
        rm[i, : len(r)] = dna.encode(r)
    return [np.asarray(x) for x in _sw_wavefront(jnp.asarray(qm), jnp.asarray(rm), *PARAMS)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scores_match_jax_and_naive(seed):
    queries, refs = _pairs(seed)
    best, qend, rend = BatchAligner(*PARAMS, device="cpu").scores(queries, refs)
    j_best, j_qend, j_rend = _jax_scores(queries, refs)
    np.testing.assert_array_equal(best, j_best)
    np.testing.assert_array_equal(qend, j_qend)
    np.testing.assert_array_equal(rend, j_rend)
    assert best.tolist() == [naive_best_score(q, r) for q, r in zip(queries, refs)]


def test_end_positions():
    aligner = BatchAligner(device="cpu")
    best, qend, rend = aligner.scores(["ACGTACGT"], ["TTTACGTACGTTTT"])
    assert (int(best[0]), int(qend[0]), int(rend[0])) == (16, 7, 10)
    assert aligner.best_scores(["ACGTACGT"], ["TTTACGTACGTTTT"]).tolist() == [16]
    # no positive cell: best 0, no end positions
    best, qend, rend = aligner.scores(["AAAA"], ["TTTT"])
    assert (int(best[0]), int(qend[0]), int(rend[0])) == (0, -1, -1)


EDGES = {case[0]: case for case in sw_edge_cases()}


@pytest.mark.parametrize("label", list(EDGES))
def test_edge_case_plain_matches_jax(label):
    """K5's edge shapes (which chip_smoke.py holds the kernel to on the
    card): the plain version equals JAX's _sw_wavefront, scores and ends."""
    _label, queries, refs, params = EDGES[label]
    got = sw_wavefront_plain(torch.from_numpy(queries), torch.from_numpy(refs), *params)
    want = _sw_wavefront(jnp.asarray(queries), jnp.asarray(refs), *params)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_edge_cases_cover_the_kernel_widths():
    """Every M of the wrapper's edges (one row a lane, a full warp, one row
    past it, the main path's 150, the widest 1,023 of one launch, and the
    strips past it: 1,024, 1,025, 2,047 and 3,000) with N of 1, M - 1 and
    400, both batch sizes and all three parameter sets; the ties and the
    empty alignments are among them, and score as named."""
    shapes = {(q.shape[1], r.shape[1]) for _l, q, r, _p in EDGES.values()}
    for M in (1, 31, 32, 33, 150, 1023, 1024, 1025, 2047, 3000):
        assert {(M, N) for N in {1, M - 1, 400} - {0}} <= shapes
    assert {q.shape[0] for _l, q, _r, _p in EDGES.values()} == {1, 5}
    assert {p for _l, _q, _r, p in EDGES.values()} == set(EDGE_PARAMS)
    ends = {label: [x.tolist() for x in sw_wavefront_plain(
        torch.from_numpy(q), torch.from_numpy(r), *p)] for label, (_l, q, r, p) in EDGES.items()
        if q.shape[1] <= 4}
    assert ends["tie across diagonals"] == [[8], [3], [3]]
    assert ends["tie on one diagonal"] == [[2], [0], [1]]
    for label in ("no match: best 0, ends -1", "padding only: best 0, ends -1"):
        _l, q, r, p = EDGES[label]
        best, qend, rend = sw_wavefront_plain(torch.from_numpy(q), torch.from_numpy(r), *p)
        assert not best.any() and (qend == -1).all() and (rend == -1).all()


def test_long_query_strips_and_ties():
    """A query longer than one launch's 1,023 rows runs as strips of 992
    (the last takes the rest); the plain version places the equal bests of
    `long_query_cases` in two strips as named: the later rows' smaller
    diagonal wins, and on one diagonal the smaller row; the alignment across
    the strips scores above 2 x 290."""
    assert sw_strips(1023) == [(0, 1023)]
    assert sw_strips(1024) == [(0, 992), (992, 32)]
    assert sw_strips(3000) == [(0, 992), (992, 992), (1984, 992), (2976, 24)]
    assert sw_strips(2 * STRIP_ROWS) == [(0, 992), (992, 992)]
    for b in (992, 1023):
        for label, want in (("the later strip's diagonal first", [[16], [b + 7], [99]]),
                            ("one diagonal", [[16], [b - 1], [107]])):
            _l, q, r, p = EDGES[f"tie across rows {b}/{b + 1}: {label}"]
            got = sw_wavefront_plain(torch.from_numpy(q), torch.from_numpy(r), *p)
            assert [x.tolist() for x in got] == want, label
    _l, q, r, p = EDGES["one alignment across the strips, a gap down rows 992-993"]
    best, qend, _rend = sw_wavefront_plain(torch.from_numpy(q), torch.from_numpy(r), *p)
    assert int(best[0]) > 2 * 290 and int(qend[0]) >= 1149
