"""`python -m siga_tpu_torch correct --device cpu` against `siga correct` (the
JAX package's CLI) on a small simulated 0.5%-error read set, one case per
route: the batch and streaming window tables, the host FM-index counts, and
the device k-mer counter (K7's plain version here), reached with k > 64 or
with the index of another read set.  The output files must be byte-equal."""
import contextlib
import os
import shutil

import numpy as np
import pytest

from siga_tpu import cli as jax_cli
from siga_tpu_torch import cli as port_cli

# route: (arguments, what the port's log names, reads corrected)
ROUTES = {
    "auto_batch": (["-k", "31", "-p", "reads"], "batch window table", "reads"),
    "stream": (["-k", "31", "-p", "reads", "--engine=stream"], "streaming window table", "reads"),
    "host": (["-k", "31", "-p", "reads", "--engine=host"], "FMIndex.occurrences", "reads"),
    "k81_counter": (["-k", "81", "-p", "long"], "k-mer counter K7 on cpu", "long"),
    "other_index_counter": (["-k", "27", "-p", "other"], "k-mer counter K7 on cpu", "reads"),
}


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _simulate(rng, genome, n, readlen, err, prefix):
    records = []
    for i in range(n):
        s = int(rng.integers(0, len(genome) - readlen))
        seq = np.frombuffer(genome[s : s + readlen].encode(), dtype=np.uint8).copy()
        hit = rng.random(readlen) < err
        seq[hit] = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, int(hit.sum()))]
        qual = "".join(chr(33 + int(q)) for q in rng.integers(8, 40, readlen))
        records.append(f"@{prefix}{i}\n{seq.tobytes().decode()}\n+\n{qual}\n")
    return "".join(records)


@pytest.fixture(scope="module")
def reads_dir(tmp_path_factory):
    """300 reads of 100 bp (0.5% errors, random qualities) from a 2 kb genome
    and another 200 from it, and 60 reads of 150 bp from a 600 bp genome,
    each set indexed forward only.  At k = 81 the corrector counts every
    candidate of every weak base on its own, so that set stays small."""
    td = tmp_path_factory.mktemp("correct")
    rng = np.random.default_rng(21)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 2000))
    (td / "reads.fastq").write_text(_simulate(rng, genome, 300, 100, 0.005, "r"))
    (td / "other.fastq").write_text(_simulate(rng, genome, 200, 100, 0.005, "o"))
    short_genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 600))
    (td / "long.fastq").write_text(_simulate(rng, short_genome, 60, 150, 0.005, "l"))
    with _cwd(td):
        for name in ("reads", "other", "long"):
            assert port_cli.main(
                ["index", "--device", "cpu", "--no-reverse", "-p", name, f"{name}.fastq"]
            ) == 0
    return td


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_correct_route_matches_jax(reads_dir, tmp_path, capsys, route):
    args, route_text, name = ROUTES[route]
    port, ref = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(reads_dir, port)
    shutil.copytree(reads_dir, ref)
    reads = f"{name}.fastq"
    with _cwd(port):
        assert port_cli.main(["correct", "--device", "cpu", *args, "-o", "ec.fa", reads]) == 0
    err = capsys.readouterr().err
    assert route_text in err
    # the plain versions on the CPU are not kernel launches
    assert "[correct] kernel launches: {}" in err
    with _cwd(ref):
        assert jax_cli.main(["correct", *args, "-o", "ec.fa", reads]) == 0
    got = (port / "ec.fa").read_bytes()
    assert got == (ref / "ec.fa").read_bytes()
    n_in = (port / reads).read_text().count("\n") // 4
    assert got.count(b">") > 0.8 * n_in
