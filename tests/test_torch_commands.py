"""The shared commands through the port's CLI (`preprocess`, `match`, `preqc
--simple`, `subgraph`, `gan`): the files and the standard output each writes
equal what `siga` (the JAX package's CLI) writes, byte for byte (gzip files
compared decompressed)."""
import contextlib
import gzip
import os
import shutil

import numpy as np
import pytest

from siga_tpu import cli as jax_cli
from siga_tpu_torch import cli as port_cli

# case: (argv, files it writes)
CASES = {
    "preprocess": (["preprocess", "-q", "20", "-m", "50", "-o", "pp.fastq", "reads.fastq"],
                   ["pp.fastq"]),
    "preprocess_pe": (["preprocess", "--pe-mode=1", "--pe-orientation=ff", "--no-primer-check",
                       "-o", "pe.fastq", "r1.fasta", "r2.fasta"], ["pe.fastq"]),
    "match": (["match", "-p", "reads", "-l", "40", "reads.fastq"], []),
    "preqc_simple": (["preqc", "--simple", "--sample-rate=0.5", "reads.fastq"], []),
    "subgraph": (["subgraph", "--size=3", "-o", "sub.asqg.gz", "r7", "reads.asqg.gz"],
                 ["sub.asqg.gz"]),
    "gan": (["gan", "-p", "g", "--ref", "reads", "reads.asqg.gz"], ["g-gan.fa", "g-gan.asqg.gz"]),
}


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _content(path):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """120 reads of 80-100 bp with qualities from both strands of a 1.5 kb
    genome (some bases N), a read pair set, the reads' index and overlaps."""
    td = tmp_path_factory.mktemp("commands")
    rng = np.random.default_rng(9)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 1500))
    comp = str.maketrans("ACGT", "TGCA")
    with open(td / "reads.fastq", "w") as f:
        for i in range(120):
            n = int(rng.integers(80, 101))
            s = int(rng.integers(0, len(genome) - n))
            seq = genome[s : s + n]
            if rng.random() < 0.5:
                seq = seq.translate(comp)[::-1]
            qual = "".join(chr(33 + int(q)) for q in rng.integers(2, 41, n))
            f.write(f"@r{i}\n{seq}\n+\n{qual}\n")
    for mate in (1, 2):
        with open(td / f"r{mate}.fasta", "w") as f:
            for i in range(60):
                s = int(rng.integers(0, len(genome) - 100))
                seq = genome[s : s + 100]
                if rng.random() < 0.1:
                    seq = seq[:30] + "N" + seq[31:]
                f.write(f">p{i}/{mate}\n{seq}\n")
    with _cwd(td):
        assert port_cli.main(["index", "--device", "cpu", "-p", "reads", "reads.fastq"]) == 0
        assert port_cli.main(["overlap", "--device", "cpu", "-m", "30", "-p", "reads",
                              "reads.fastq"]) == 0
    return td


@pytest.mark.parametrize("case", sorted(CASES))
def test_command_writes_what_jax_writes(workdir, tmp_path, capsys, case):
    argv, files = CASES[case]
    outs = []
    for name, main in (("port", port_cli.main), ("jax", jax_cli.main)):
        d = tmp_path / name
        shutil.copytree(workdir, d)
        capsys.readouterr()
        with _cwd(d):
            assert main(list(argv)) == 0, name
        outs.append((capsys.readouterr().out, [_content(d / f) for f in files]))
    assert outs[0] == outs[1]
    assert outs[0][0] or any(outs[0][1]), "the command wrote nothing"
