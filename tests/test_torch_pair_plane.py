"""The pair-plane build (K2) on the CPU against the JAX program and the C++
packer, at the edges of the kernel's blocks and tiles.

`build_pair_plane` on a CPU tensor runs `build_pair_plane_plain`, the
version the CUDA kernel (`csrc/pair_plane.cu`) is held to bit for bit on
the card by `chip_smoke.py`, on the same read sets
(`chip_smoke.plane_edge_reads`).  The plane and K are integers: equality is
exact.
"""
import numpy as np
import pytest
import torch

from siga_tpu.index import sa as jax_sa
from siga_tpu.index.fm import FMIndex
from siga_tpu.ops import fm_device as jfm
from siga_tpu_torch import kernels
from siga_tpu_torch.ops import fm_device as tfm

from chip_smoke import plane_edge_reads

EDGE_READS = plane_edge_reads()
TILE_BLOCKS = 64  # plane rows a tile of the kernel (`csrc/pair_plane.cu`)


@pytest.fixture(scope="module")
def indexes():
    """{label: (forward FMIndex, reverse FMIndex)}, built lazily."""
    cache = {}

    def get(label):
        if label not in cache:
            fwd, _p, rev, _rp, ns = jax_sa.build_index_arrays_pair(
                EDGE_READS[label], use_device=False
            )
            cache[label] = (FMIndex(fwd, ns), FMIndex(rev, ns))
        return cache[label]

    return get


def _build(host):
    codes = torch.from_numpy(np.ascontiguousarray(host.codes))
    pred = np.asarray(host.pred, dtype=np.int64)
    return tfm.build_pair_plane(codes, pred, host.length // tfm.SAMPLE + 1)


def test_edge_texts_cover_the_edges(indexes):
    """The read sets give the text lengths and symbol sets their labels name."""
    lengths = {label: indexes(label)[0].length for label in EDGE_READS}
    assert lengths["one block (n 73)"] == 73
    assert [lengths[f"n {n} ({r} mod 128)"] % 128 for n, r in ((384, 0), (385, 1), (383, 127))] \
        == [0, 1, 127]
    assert lengths["one tile exactly (n 16,384)"] == 128 * 128
    assert lengths["three tiles (n 45,300)"] // 128 + 1 > 2 * 128
    for label in ("homopolymer (n 301)", "no T (n 455)"):
        fmi = indexes(label)[0]
        assert fmi.pred[4] == fmi.length  # K reads the last, partial block
    tile_rows = 2 * TILE_BLOCKS * tfm.SAMPLE  # a tile at 128 plane rows, two at 64
    for label in ("homopolymer over several tiles (n 40,004)", "no T over several tiles (n 40,400)"):
        fmi = indexes(label)[0]
        assert fmi.length > 2 * tile_rows and fmi.pred[4] == fmi.length  # an empty run a tile
    fmi = indexes("C[3] on a tile's first row (n 30,200)")[0]
    assert fmi.pred[3] == tile_rows < fmi.length
    fmi = indexes("odd run starts, a run ends at n (n 36,421)")[0]
    assert fmi.length > 2 * tile_rows and fmi.length % 16
    assert all(p % 2 for p in fmi.pred[1:])  # the first tile's runs start at C[1..4]


@pytest.mark.parametrize("direction", [0, 1], ids=["forward", "reverse"])
@pytest.mark.parametrize("label", list(EDGE_READS))
def test_plane_and_K_match_jax_and_host(indexes, label, direction):
    host = indexes(label)[direction]
    plane, K = _build(host)
    assert plane.dtype == torch.int32 and K.dtype == torch.int32
    assert plane.shape == (host.length // tfm.SAMPLE + 1, tfm.PAIR_COLS) and K.shape == (5, 5)
    plane_j, K_j = jfm.DeviceFM(host).pair_plane_device()
    np.testing.assert_array_equal(plane.numpy(), np.asarray(plane_j))
    np.testing.assert_array_equal(K.numpy(), np.asarray(K_j))
    plane_h, K_h = tfm.pair_plane_host(host)
    np.testing.assert_array_equal(plane.numpy(), plane_h)
    np.testing.assert_array_equal(K.numpy(), K_h)


def _prev_codes(plane, n):
    """Each row's prev code (0 for '$') from the plane's prev words and
    their '$' mask."""
    shifts = 2 * np.arange(16, dtype=np.uint32)
    words = plane[:, 8:16].view(np.uint32)[:, :, None] >> shifts
    dollar = plane[:, 24:32].view(np.uint32)[:, :, None] >> shifts
    prev = np.where(dollar & 1, 0, (words & 3) + 1)
    return prev.reshape(-1)[:n]


@pytest.mark.parametrize("blocks", [TILE_BLOCKS, 2 * TILE_BLOCKS], ids=lambda b: f"tile {b}")
@pytest.mark.parametrize("direction", [0, 1], ids=["forward", "reverse"])
@pytest.mark.parametrize("label", list(EDGE_READS))
def test_tile_prevs_are_runs_of_the_codes(indexes, label, direction, blocks):
    """What the kernel's design rests on: in each tile of `blocks` plane
    rows (rows [R0, R1) of the BWT; the kernel's tile and twice it), the
    prevs of the rows of symbol c, in row order, are
    codes[C[c] + occ_c(R0) : C[c] + occ_c(R1)], one contiguous run; over
    all tiles the runs cover [C[1], n) once.  The runs come from the numpy
    codes, the prevs from the plane `build_pair_plane_plain` writes."""
    host = indexes(label)[direction]
    n, codes = host.length, np.asarray(host.codes)
    pred = np.asarray(host.pred, dtype=np.int64)
    plane, _K = _build(host)
    prev = _prev_codes(plane.numpy(), n)
    occ = np.zeros((5, n + 1), dtype=np.int64)  # occ[c, r]: rows before r holding c
    for c in range(1, 5):
        occ[c, 1:] = np.cumsum(codes == c)
    covered = np.zeros(n, dtype=np.int64)
    tile_rows = blocks * tfm.SAMPLE
    for r0 in range(0, (n // tfm.SAMPLE + 1) * tfm.SAMPLE, tile_rows):
        r1 = min(r0 + tile_rows, n)
        rows = codes[r0:r1]
        for c in range(1, 5):
            start, stop = pred[c] + occ[c, r0], pred[c] + occ[c, r1]
            np.testing.assert_array_equal(prev[r0:r1][rows == c], codes[start:stop])
            covered[start:stop] += 1
        assert not prev[r0:r1][rows == 0].any()  # '$' rows have prev '$'
    assert not covered[: pred[1]].any() and (covered[pred[1] :] == 1).all()


def test_cpu_route_is_the_plain_version(indexes, monkeypatch):
    """On a CPU tensor the wrapper returns the plain version's result, counts
    no launch and never loads the kernels."""
    host = indexes("mixed lengths")[0]
    calls = []
    plain = tfm.build_pair_plane_plain

    def spy(*args):
        calls.append(args)
        return plain(*args)

    def no_lib():
        raise AssertionError("the CPU route loaded the kernels")

    monkeypatch.setattr(tfm, "build_pair_plane_plain", spy)
    monkeypatch.setattr(kernels, "lib", no_lib)
    before = kernels.launches["pair_plane"]
    plane, K = _build(host)
    assert len(calls) == 1 and kernels.launches["pair_plane"] == before
    want = plain(*calls[0])
    assert torch.equal(plane, want[0]) and torch.equal(K, want[1])


def test_device_fm_builds_through_the_wrapper(indexes, monkeypatch):
    host = indexes("one read (n 701)")[0]
    seen = []
    wrapper = tfm.build_pair_plane
    monkeypatch.setattr(
        tfm, "build_pair_plane", lambda *a: seen.append(a[0].device) or wrapper(*a)
    )
    dfm = tfm.DeviceFM(host, "cpu")
    assert seen == []  # built at its first use
    plane_h, K_h = tfm.pair_plane_host(host)
    np.testing.assert_array_equal(dfm.plane.numpy(), plane_h)
    np.testing.assert_array_equal(dfm.K.numpy(), K_h)
    assert seen == [torch.device("cpu")]  # plane and K from one build


def _good(n=300):
    codes = torch.zeros(n, dtype=torch.uint8)
    codes[1:] = 1
    return codes, np.array([0, 1, n, n, n]), n // tfm.SAMPLE + 1


@pytest.mark.parametrize(
    "case",
    ["int32 codes", "2-d codes", "non-contiguous codes", "too large", "nblocks", "pred shape",
     "pred falls", "pred past n", "pred[0]", "meta device"],
)
def test_wrapper_refuses_bad_input(case, monkeypatch):
    """Bad input raises before any launch, on the CPU route as on the card."""
    monkeypatch.setattr(kernels, "lib", lambda: pytest.fail("a refused input reached the kernels"))
    codes, pred, nblocks = _good()
    if case == "int32 codes":
        codes = codes.to(torch.int32)
    elif case == "2-d codes":
        codes = codes.view(3, 100)
    elif case == "non-contiguous codes":
        codes = torch.zeros(600, dtype=torch.uint8)[::2]
    elif case == "too large":  # a stride-0 view: no memory behind it
        codes = torch.zeros(1, dtype=torch.uint8).expand(tfm.MAX_PLANE_CODES)
        nblocks = tfm.MAX_PLANE_CODES // tfm.SAMPLE + 1
    elif case == "nblocks":
        nblocks += 1
    elif case == "pred shape":
        pred = pred[:4]
    elif case == "pred falls":
        pred = np.array([0, 5, 4, 300, 300])
    elif case == "pred past n":
        pred = np.array([0, 1, 300, 300, 301])
    elif case == "pred[0]":
        pred = np.array([1, 1, 300, 300, 300])
    elif case == "meta device":
        codes = torch.empty(300, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError) as err:
        tfm.build_pair_plane(codes, pred, nblocks)
    if case == "too large":
        assert str(tfm.MAX_PLANE_CODES) in str(err.value)


def test_plane_size_limit_keeps_n_pad_in_int32():
    n = tfm.MAX_PLANE_CODES - 1  # the largest text the build takes
    assert (n // tfm.SAMPLE + 1) * tfm.SAMPLE <= 2**31 - 1


def test_kernel_is_registered():
    assert kernels._SIGNATURES["siga_pair_plane"][0] is kernels._P
    assert len(kernels._SIGNATURES["siga_pair_plane"]) == 12
    assert kernels._SIGNATURES["siga_pair_plane_scratch"] == [kernels._I]
    assert "pair_plane" in kernels.launches
