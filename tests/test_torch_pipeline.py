"""The `benchmark/ecoli_scale.py` stage list at a small size: the same read
generator, every stage through the port's CLI (`--device cpu`) and through
`siga` (the JAX package's CLI), and each stage's output files equal byte for
byte (gzip files compared decompressed)."""
import contextlib
import gzip
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from siga_tpu import cli as jax_cli
from siga_tpu_torch import cli as port_cli

from chip_smoke import pipeline_stages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME = 8_000  # bases; the full-size run is 1,000,000 (chip_smoke.py)
STAGE_NAMES = [name for name, _argv in pipeline_stages("r1", "r2")]


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _snapshot(d):
    return {n: os.stat(os.path.join(d, n)).st_mtime_ns for n in os.listdir(d)}


def _content(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs over the same generated read set, one directory each.
    Returns (port dir, jax dir, {stage: files it wrote in the port dir})."""
    td = tmp_path_factory.mktemp("pipeline")
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[
        np.random.default_rng(42).integers(0, 4, GENOME)
    ].tobytes().decode()
    with open(td / "ref.fa", "w") as f:
        f.write(">ref\n" + "".join(genome[i : i + 80] + "\n" for i in range(0, GENOME, 80)))
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmark", "paired_read_gen.py"), "ref.fa",
         "150", "25", "400", "20", "1", "0.005"],
        cwd=td, check=True, capture_output=True, text=True,
    )
    prefix = out.stdout.strip().splitlines()[-1]
    r1, r2 = f"{prefix}_R1.fasta", f"{prefix}_R2.fasta"
    port, ref = td / "port", td / "jax"
    for d in (port, ref):
        d.mkdir()
        for name in (r1, r2):
            shutil.copy(td / name, d / name)
    written = {}
    for (name, argv), (_name, jax_argv) in zip(
        pipeline_stages(r1, r2, "cpu"), pipeline_stages(r1, r2)
    ):
        before = _snapshot(port)
        with _cwd(port):
            assert port_cli.main(argv) == 0, argv
        after = _snapshot(port)
        written[name] = sorted(n for n, t in after.items() if before.get(n) != t)
        with _cwd(ref):
            assert jax_cli.main(jax_argv) == 0, jax_argv
    return port, ref, written


@pytest.mark.parametrize("stage", STAGE_NAMES)
def test_stage_outputs_equal_jax(runs, stage):
    port, ref, written = runs
    assert written[stage], f"{stage} wrote nothing"
    for name in written[stage]:
        assert _content(str(port / name)) == _content(str(ref / name)), f"{stage}: {name}"


def test_same_files_and_contigs(runs):
    port, ref, _written = runs
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    with open(port / "final-contigs.fa") as f:
        contigs = [line for line in f if not line.startswith(">")]
    assert contigs and sum(len(c.strip()) for c in contigs) > GENOME // 2
