"""The `benchmark/ecoli_scale.py` stage list at a small size: the same read
generator, every stage through the port's CLI (`--device cpu`, each stage a
child process in which jax and the JAX package cannot be imported) and
through `siga` (the JAX package's CLI, in this process), and each stage's
output files equal byte for byte (gzip files compared decompressed)."""
import contextlib
import gzip
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from siga_tpu import cli as jax_cli

from chip_smoke import pipeline_stages
from test_torch_import import BLOCKER

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME = 8_000  # bases; the full-size run is 1,000,000 (chip_smoke.py)
STAGE_NAMES = [name for name, _argv in pipeline_stages("r1", "r2")]
# one port stage: the CLI with jax and siga_tpu blocked, then a check that
# neither was loaded on the way
_PORT_STAGE = BLOCKER + r"""
import json
from siga_tpu_torch import cli
rc = cli.main(json.loads(sys.argv[1]))
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "siga_tpu")]
print("PORT_STAGE_OK" if rc == 0 and not loaded else f"rc {rc}, loaded {loaded}")
sys.exit(rc)
"""


def _port_stage(argv, cwd):
    """Run `argv` through the port's CLI in a blocked child; its stdout."""
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_STAGE, json.dumps(argv)], cwd=cwd,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p)},
        capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, (argv, proc.stdout[-2000:], proc.stderr[-4000:])
    return proc.stdout


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
    Returns (port dir, jax dir, {stage: files it wrote in the port dir},
    {stage: the port child's stdout})."""
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
    written, said = {}, {}
    for (name, argv), (_name, jax_argv) in zip(
        pipeline_stages(r1, r2, "cpu"), pipeline_stages(r1, r2)
    ):
        before = _snapshot(port)
        said[name] = _port_stage(argv, port)
        after = _snapshot(port)
        written[name] = sorted(n for n, t in after.items() if before.get(n) != t)
        with _cwd(ref):
            assert jax_cli.main(jax_argv) == 0, jax_argv
    return port, ref, written, said


@pytest.mark.parametrize("stage", STAGE_NAMES)
def test_stage_outputs_equal_jax(runs, stage):
    port, ref, written, _said = runs
    assert written[stage], f"{stage} wrote nothing"
    for name in written[stage]:
        assert _content(str(port / name)) == _content(str(ref / name)), f"{stage}: {name}"


def test_same_files_and_contigs(runs):
    port, ref, _written, _said = runs
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    with open(port / "final-contigs.fa") as f:
        contigs = [line for line in f if not line.startswith(">")]
    assert contigs and sum(len(c.strip()) for c in contigs) > GENOME // 2


def test_port_stages_ran_without_the_jax_package(runs):
    """Every port stage ran to its end in a process where jax and siga_tpu
    could not be imported, and loaded neither."""
    _port, _ref, _written, said = runs
    assert sorted(said) == sorted(STAGE_NAMES)
    for name, out in said.items():
        assert "PORT_STAGE_OK" in out.splitlines(), (name, out[-500:])
