"""The port's overlap modes: two gloo worker processes plus `--merge-only -t 2`
against the port's single-process `-t 2` run and the JAX package's, and
`--engine=host` against the device route (`--device cpu`, the plain scan)."""
import contextlib
import gzip
import os
import random
import shutil

import pytest

from siga_tpu import cli as jax_cli
from siga_tpu_torch import cli as port_cli
from siga_tpu_torch.parallel import multihost


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _port(cwd, *args):
    with _cwd(cwd):
        assert port_cli.main(list(args)) == 0


def _jax(cwd, *args):
    with _cwd(cwd):
        assert jax_cli.main(list(args)) == 0


def _read(path):
    with gzip.open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    """150 reads of 60-80 bp from both strands of a 1,200 bp genome, indexed."""
    td = tmp_path_factory.mktemp("overlap_modes")
    rng = random.Random(5)
    genome = "".join(rng.choice("ACGT") for _ in range(1200))
    comp = str.maketrans("ACGT", "TGCA")
    with open(td / "reads.fa", "w") as f:
        for i in range(150):
            n = rng.randint(60, 80)
            s = rng.randint(0, len(genome) - n)
            seq = genome[s : s + n]
            if rng.random() < 0.5:
                seq = seq.translate(comp)[::-1]
            f.write(f">r{i}\n{seq}\n")
    _port(td, "index", "--device", "cpu", "-p", "reads", "reads.fa")
    return td


def test_workers_and_merge_equal_single_process(indexed, tmp_path):
    single, workers, ref = tmp_path / "single", tmp_path / "workers", tmp_path / "jax"
    for d in (single, workers, ref):
        shutil.copytree(indexed, d)
    _port(single, "overlap", "--device", "cpu", "-m", "30", "-t", "2", "-p", "reads", "reads.fa")
    with _cwd(workers):
        multihost.launch_overlap_2proc("reads.fa", "reads", 30, extra_args=["--device", "cpu"])
    _jax(ref, "overlap", "-m", "30", "-t", "2", "-p", "reads", "reads.fa")
    for i in range(2):
        shard = f"reads-thread{i}.hits.gz"
        assert _read(workers / shard) == _read(single / shard), shard
    merged = _read(workers / "reads.asqg.gz")
    assert merged == _read(single / "reads.asqg.gz")
    assert merged == _read(ref / "reads.asqg.gz")
    assert merged.count(b"\nED\t") > 100


@pytest.mark.parametrize("extra", [[], ["--no-opposite-strand"], ["-x"]])
def test_host_engine_equals_device_engine(indexed, tmp_path, capsys, extra):
    outs = []
    for engine in ("host", "tpu"):
        d = tmp_path / engine
        shutil.copytree(indexed, d)
        _port(d, "overlap", "--device", "cpu", f"--engine={engine}", "-m", "25",
              *extra, "-p", "reads", "reads.fa")
        assert f"engine {engine} on cpu" in capsys.readouterr().err
        outs.append(_read(d / "reads.asqg.gz"))
    assert outs[0] == outs[1]


def test_worker_failure_raises(indexed, tmp_path):
    """A worker that exits non-zero stops the launch; nothing is merged."""
    d = tmp_path / "bad"
    shutil.copytree(indexed, d)
    with _cwd(d), pytest.raises(RuntimeError, match="workers failed"):
        multihost.launch_overlap_2proc("reads.fa", "missing", 30, extra_args=["--device", "cpu"])
    assert not os.path.exists(d / "missing.asqg.gz")
