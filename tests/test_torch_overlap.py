"""The port's commands end to end: index -> overlap -> assemble through
`python -m siga_tpu_torch` (overlap on `--device cpu`, the plain PyTorch
scan), byte-compared with the frozen fixtures and with the JAX package."""
import gzip
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest

from siga_tpu import cli as jax_cli
from siga_tpu.io import bwtio, sai
from siga_tpu_torch.index import sa as torch_sa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


def _port(cwd, *args):
    proc = subprocess.run(
        [sys.executable, "-m", "siga_tpu_torch", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr


@pytest.fixture(scope="module")
def asm780(tmp_path_factory):
    td = tmp_path_factory.mktemp("torch_asm")
    shutil.copy(os.path.join(GOLDEN, "asm780-reads.fa"), td / "reads.rmdup.fa")
    _port(td, "index", "-p", "reads.rmdup", "reads.rmdup.fa")
    _port(td, "overlap", "--device", "cpu", "-m", "45", "-p", "reads.rmdup", "reads.rmdup.fa")
    _port(td, "assemble", "-m", "45", "-x", "0", "-p", "asm", "reads.rmdup.asqg.gz")
    return td


@pytest.mark.parametrize(
    "got, want, zipped",
    [
        ("reads.rmdup.asqg.gz", "asm780.asqg", True),
        ("asm-contigs.fa", "asm780-contigs.fa", False),
        ("asm-graph.asqg.gz", "asm780-graph.asqg", True),
    ],
)
def test_asm780_bytes(asm780, got, want, zipped):
    opener = gzip.open if zipped else open
    with opener(asm780 / got, "rb") as f:
        got_bytes = f.read()
    with open(os.path.join(GOLDEN, want), "rb") as f:
        assert got_bytes == f.read(), f"{got} differs from tests/golden/{want}"


def test_host_index_matches_golden(tmp_path):
    seqs = ["ACGTACGTAC", "CGTACGTACC", "TTACGGACGT", "ACGTACGTAC", "GGGTTTACAC"]
    for reads, sai_name, bwt_name in (
        (seqs, "fixed.sai", "fixed.bwt"),
        ([s[::-1] for s in seqs], "fixed.rsai", "fixed.rbwt"),
    ):
        bwt_codes, perm, ns = torch_sa.build_index_arrays(reads)
        sai.save_sai(str(tmp_path / sai_name), perm, ns)
        bwtio.save_bwt(str(tmp_path / bwt_name), bwt_codes, ns)
        for name in (sai_name, bwt_name):
            with open(tmp_path / name, "rb") as a, open(os.path.join(GOLDEN, name), "rb") as b:
                assert a.read() == b.read(), name


@pytest.mark.parametrize("irreducible, rc", [(True, True), (False, True), (True, False)])
def test_engine_hits_match_host_engine(irreducible, rc):
    """The port's engine (plain scan + native stage B/C) against the shared
    host engine, hit for hit (the check chip_smoke.py makes on the card)."""
    from siga_tpu.index.fm import FMIndex
    from siga_tpu.io.fastx import DNASeq
    from siga_tpu.overlap.builder import Hit, OverlapBuilder
    from siga_tpu_torch.ops.search import batch_overlap_hits

    from naive import revcomp
    from test_overlap import random_genome, tiled_reads

    rng = random.Random(17)
    reads = tiled_reads(random_genome(rng, 900), 70, 23)
    reads["rcx"] = revcomp(reads["r003"])
    reads["dup"] = reads["r005"]
    seqs = list(reads.values())
    fwd = torch_sa.build_index_arrays(seqs)
    rev = torch_sa.build_index_arrays([s[::-1] for s in seqs])
    builder = OverlapBuilder(
        FMIndex(fwd[0], fwd[2]), FMIndex(rev[0], rev[2]), irreducible=irreducible, rc=rc
    )
    records = [DNASeq(name=n, seq=s) for n, s in reads.items()]
    got = [h.serialize() for h in batch_overlap_hits(builder, records, 22, "cpu")]
    want = []
    for i, s in enumerate(seqs):
        hit = Hit(idx=i)
        hit.substring = builder.overlap(s, 22, hit.blocks).substring
        want.append(hit.serialize())
    assert got == want


def _recipe_reads():
    """600 reads of 73, 100 or 111 bp from a 60 kb genome, plus one read
    containing another and two exact duplicates of r0."""
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, 60000)
    reads = []
    for _ in range(600):
        s = rng.integers(0, 60000 - 120)
        L = int(rng.choice([73, 100, 111]))
        reads.append("".join("ACGT"[c] for c in g[s : s + L]))
    reads.append("".join("ACGT"[c] for c in g[100:220]))
    reads.append("".join("ACGT"[c] for c in g[110:190]))
    reads += [reads[0], reads[0]]
    return "".join(f">r{i}\n{s}\n" for i, s in enumerate(reads))


def test_containment_only_overlap_matches_jax(tmp_path):
    port, ref = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    (port / "reads.fa").write_text(_recipe_reads())
    _port(port, "index", "-p", "reads", "reads.fa")
    shutil.copytree(port, ref)
    _port(port, "overlap", "--device", "cpu", "-m", "200", "-p", "reads", "reads.fa")
    cwd = os.getcwd()
    os.chdir(ref)
    try:
        assert jax_cli.main(
            ["overlap", "-m", "200", "--engine=tpu", "-p", "reads", "reads.fa"]
        ) == 0
    finally:
        os.chdir(cwd)
    got = gzip.open(port / "reads.asqg.gz").read()
    assert got == gzip.open(ref / "reads.asqg.gz").read()
    # containment edges only: the duplicates of r0 and the contained r601
    assert got.count(b"\nVT\t") == 604 and b"\nED\t" in got
