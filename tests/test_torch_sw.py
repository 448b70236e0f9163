"""The port's Smith-Waterman wavefront against the JAX package and the naive
DP.  Scores and end positions are integers: equality is exact."""
import random

import jax.numpy as jnp
import numpy as np
import pytest

from siga_tpu.core import dna
from siga_tpu.ops.sw_device import _sw_wavefront
from siga_tpu_torch.ops.sw import BatchAligner

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
