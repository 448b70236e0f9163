"""The port's `rmdup` (plain scan on `--device cpu`) against the JAX package's
`rmdup` and the shared host engine.  Files are compared byte for byte (the
gzip'd hits file by its content: gzip stamps a time in its header)."""
import gzip
import os
import random
import shutil

import pytest

from siga_tpu import cli as jax_cli
from siga_tpu.index.fm import FMIndex
from siga_tpu.io.fastx import DNASeq
from siga_tpu.overlap.builder import Hit, OverlapBuilder
from siga_tpu_torch import cli
from siga_tpu_torch.index import sa as torch_sa
from siga_tpu_torch.ops.search import batch_duplicate_hits

from test_pipeline import random_genome, tiled_reads, write_fastq
from test_torch_overlap import _recipe_reads

OUTPUTS = ("reads.rmdup.fa", "reads.rmdup.dups.fa")
HITS = "reads-thread0.rmdup.hits.gz"


def _pipeline_reads(path):
    """The input of tests/test_pipeline.py::test_rmdup_removes_duplicates."""
    rng = random.Random(8)
    reads = tiled_reads(random_genome(rng, 500), 60, 30)
    reads.append(("dup0", reads[0][1]))
    write_fastq(path, reads)


def _recipe(path):
    with open(path, "w") as f:
        f.write(_recipe_reads())


@pytest.mark.parametrize("make_reads", [_recipe, _pipeline_reads], ids=["recipe", "pipeline"])
def test_rmdup_matches_jax(tmp_path, make_reads):
    port, ref = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    make_reads(port / "reads.fa")
    assert cli.main(["index", "--device", "cpu", "-p", str(port / "reads"), str(port / "reads.fa")]) == 0
    shutil.copytree(port, ref)
    cwd = os.getcwd()
    try:
        os.chdir(port)
        assert cli.main(["rmdup", "--device", "cpu", "-p", "reads", "reads.fa"]) == 0
        os.chdir(ref)
        assert jax_cli.main(["rmdup", "-p", "reads", "reads.fa"]) == 0
    finally:
        os.chdir(cwd)
    for name in OUTPUTS:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    with gzip.open(port / HITS) as a, gzip.open(ref / HITS) as b:
        assert a.read() == b.read()
    kept = (port / OUTPUTS[0]).read_text()
    dups = (port / OUTPUTS[1]).read_text()
    n_reads = sum(1 for line in (port / "reads.fa").read_text().splitlines()
                  if line[:1] in (">", "@"))
    assert kept.count(">") + dups.count(">") == n_reads
    if make_reads is _recipe:
        # r601 lies inside r600; r602 and r603 are copies of r0, which stays
        for name in ("r601", "r602", "r603"):
            assert f">{name},seqrank=" in dups
        assert ">r0 r0 " in kept


def test_duplicate_hits_match_host_engine():
    """Every read's rmdup hit (the scan's finals and `_Containments`) equals
    the shared host engine's `OverlapBuilder.duplicate`."""
    rng = random.Random(23)
    genome = random_genome(rng, 700)
    seqs = [s for _n, s in tiled_reads(genome, 64, 21)]
    seqs += [seqs[3], genome[50:90], seqs[7][5:60]]
    seqs.append("".join({"A": "T", "C": "G", "G": "C", "T": "A"}[c] for c in seqs[2][::-1]))
    fwd = torch_sa.build_index_arrays(seqs, "sais2", "cpu")
    rev = torch_sa.build_index_arrays([s[::-1] for s in seqs], "sais2", "cpu")
    builder = OverlapBuilder(FMIndex(fwd[0], fwd[2]), FMIndex(rev[0], rev[2]))
    records = [DNASeq(name=f"r{i}", seq=s) for i, s in enumerate(seqs)]
    got = [h.serialize() for h in batch_duplicate_hits(builder, records, "cpu")]
    want = []
    for i, s in enumerate(seqs):
        hit = Hit(idx=i)
        hit.substring = builder.duplicate(s, hit.blocks).substring
        want.append(hit.serialize())
    assert got == want
    assert any(h.split()[1] == "1" for h in got) and any(h.split()[2] != "0" for h in got)
