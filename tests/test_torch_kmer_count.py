"""K7's plain version (`count_kmers_plain`, on the port's pair plane) against
the JAX package's `_count_scan` (through its `KmerCounter` on the CPU) and
against `FMIndex.occurrences`: exact integer equality."""
import numpy as np
import pytest
import torch

from siga_tpu.index.fm import FMIndex
from siga_tpu.ops.fm_device import DeviceFM as JaxDeviceFM
from siga_tpu.ops.kmer_count import KmerCounter as JaxKmerCounter
from siga_tpu_torch.index import sa as torch_sa
from siga_tpu_torch.ops import kmer_count
from siga_tpu_torch.ops.fm_device import DeviceFM

KS = (1, 2, 3, 31, 41, 81)
KINDS = ("present", "absent", "with_n", "read_ends")
BATCH = 64  # every case has more k-mers than one batch


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(7)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 3000))
    seqs = []
    for _ in range(120):
        s = int(rng.integers(0, len(genome) - 130))
        seqs.append(genome[s : s + int(rng.integers(90, 130))])
    seqs.append(genome[:200])  # repeats a prefix of the genome
    bwt, _perm, ns = torch_sa.build_index_arrays(seqs, "host")
    fmi = FMIndex(bwt, ns)
    return seqs, fmi, DeviceFM(fmi, "cpu"), JaxDeviceFM(fmi)


def _kmers(seqs, k, kind, n=150, seed=3):
    rng = np.random.default_rng(seed * 1000 + k)
    out = []
    for _ in range(n):
        s = seqs[int(rng.integers(0, len(seqs)))]
        if kind == "read_ends":
            w = s[:k] if rng.random() < 0.5 else s[len(s) - k :]
        else:
            j = int(rng.integers(0, len(s) - k + 1))
            w = list(s[j : j + k])
            p = int(rng.integers(0, k))
            if kind == "absent":
                w[p] = "ACGT"[("ACGT".index(w[p]) + int(rng.integers(1, 4))) % 4]
            elif kind == "with_n":
                w[p] = "N"
            w = "".join(w)
        out.append(w)
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", KS)
def test_counts_match_jax_and_host(index, k, kind):
    seqs, fmi, dfm, jdfm = index
    kmers = _kmers(seqs, k, kind)
    got = kmer_count.KmerCounter(dfm, batch=BATCH)(kmers)
    assert got == JaxKmerCounter(jdfm, batch=BATCH)(kmers)
    assert got == [fmi.occurrences(w) for w in kmers]
    if kind in ("present", "read_ends"):
        assert min(got) >= 1


def test_plain_takes_uint8_and_int64(index):
    seqs, fmi, dfm, _ = index
    kmers = _kmers(seqs, 41, "present") + _kmers(seqs, 41, "absent")
    codes = torch.from_numpy(kmer_count.encode_kmers(kmers))
    a = kmer_count.count_kmers(dfm, codes)
    b = kmer_count.count_kmers_plain(dfm, codes.to(torch.int64))
    assert a.dtype == torch.int32 and a.shape == (len(kmers),)
    assert torch.equal(a, b)
    assert a.tolist() == [fmi.occurrences(w) for w in kmers]


def test_bad_inputs_raise(index):
    _seqs, _fmi, dfm, _ = index
    with pytest.raises(ValueError):
        kmer_count.count_kmers(dfm, torch.full((3, 5), 5, dtype=torch.uint8))
    with pytest.raises(ValueError):
        kmer_count.count_kmers(dfm, torch.zeros((3, 5), dtype=torch.int32))
    with pytest.raises(ValueError):
        kmer_count.encode_kmers(["ACGT", "ACG"])
    assert kmer_count.count_kmers(dfm, torch.zeros((0, 5), dtype=torch.uint8)).shape == (0,)
    assert kmer_count.KmerCounter(dfm)([]) == []
