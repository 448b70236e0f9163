"""The port's multi-device dry run (`siga_tpu_torch/dryrun.py`, the
counterpart of `__graft_entry__.py::dryrun_multichip`) over [cpu] * D, its
refusal of a scan that loses a block, and the overlap worker launcher's
placement of one card a worker."""
import pytest
import torch

from siga_tpu_torch import cli, dryrun
from siga_tpu_torch.ops import fm_device as tfm
from siga_tpu_torch.parallel import dist_build, multihost


@pytest.mark.parametrize("D", [1, 2, 4])
def test_dryrun_passes(D):
    out = dryrun.dryrun_multidevice(["cpu"] * D)
    assert out["devices"] == ["cpu"] * D and out["reads"] == max(2 * D, 8)
    assert out["hits"] == out["reads"] and len(out["shard_rows"]) == D
    assert set(out["stage_a"]) == {"valid", "final", "emitted", "lext"}
    assert sum(out["shard_rows"]) == 2 * (out["reads"] * 25 // tfm.SAMPLE + 1)
    # the index step: D segments of one 128-character tile each hold the text
    assert out["segments"] == ([] if D == 1 else dist_build.segment_sizes(out["reads"] * 25, D))
    assert sum(out["segments"]) == (0 if D == 1 else out["reads"] * 25)


def _jax_stage_a_sums(n_devices):
    """The four sums `__graft_entry__.py::dryrun_multichip` reduces from
    `_scan_stage_a` over an n-device mesh of its lanes (the CPU devices of
    tests/conftest.py), computed as it computes them."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__
    from siga_tpu.core import dna
    from siga_tpu.ops.fm_device import DeviceFM, _scan_stage_a
    from siga_tpu.parallel.dist import data_mesh, pad_to_multiple

    seqs, fmi = __graft_entry__._tiny_problem(num_reads=max(2 * n_devices, 8))
    dfm = DeviceFM(fmi)
    max_t = max(len(s) for s in seqs) - 1
    chars = np.zeros((len(seqs), max_t + 1), dtype=np.int32)
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    for i, s in enumerate(seqs):
        ranks = dna.encode(s).astype(np.int32)
        for t in range(len(s) - 1):
            chars[i, t] = ranks[len(s) - 2 - t]
        chars[i, max_t] = ranks[len(s) - 1]
    chars = pad_to_multiple(chars, n_devices)
    lens = np.maximum(pad_to_multiple(np.maximum(lens, 1), n_devices), 1)
    mesh = data_mesh(n_devices)
    repl = NamedSharding(mesh, P())

    @jax.jit
    def step(plane, pred, chars, lens):
        emitted, valid, final, lext = _scan_stage_a(
            max_t, 8, plane, pred, jnp.int32(dfm.length), chars, lens)
        return valid.sum(), final.sum(), emitted.sum(), lext.sum()

    out = step(jax.device_put(np.asarray(dfm.occ_plane), repl),
               jax.device_put(np.asarray(dfm.pred), repl),
               jax.device_put(chars, NamedSharding(mesh, P("data", None))),
               jax.device_put(lens, NamedSharding(mesh, P("data"))))
    return dict(zip(("valid", "final", "emitted", "lext"), (int(x) for x in out)))


@pytest.mark.parametrize("D", [1, 2, 4])
def test_dryrun_stage_a_equals_jax(D):
    """The stage-A step over [cpu] * D (each part with a copy of the plane,
    joined in device order, held to one run of the whole batch) returns the
    sums JAX's dry run reduces over a D-device mesh."""
    out = dryrun.dryrun_multidevice(["cpu"] * D)
    assert out["stage_a"] == _jax_stage_a_sums(D)


def test_dryrun_stage_a_pads_and_joins(monkeypatch):
    """With 10 lanes over 4 devices the lanes pad to 12 (lengths 1, never
    live), each part runs on its own device, and a part that differs from
    the whole batch's run makes the dry run raise."""
    from siga_tpu_torch.index import sa
    from siga_tpu_torch.index.fm import FMIndex

    seqs = _overlapping_reads(num_reads=10)
    bwt, _perm, ns = sa.build_index_arrays(seqs, "sais2", "cpu")
    calls = []
    scan = dryrun.scan_stage_a

    def spy(*args):
        calls.append((args[5].shape[0], args[6].tolist()))
        return scan(*args)

    monkeypatch.setattr(dryrun, "scan_stage_a", spy)
    sums = dryrun.stage_a_step(seqs, FMIndex(bwt, ns), ["cpu"] * 4)
    assert [n for n, _l in calls] == [3, 3, 3, 3, 12]
    assert calls[-1][1] == [24] * 10 + [1, 1]
    assert sums["valid"] > 0  # the reads overlap: valid probes

    def lossy(*args):
        out = list(scan(*args))
        if args[5].shape[0] == 3:
            out[1] = ~out[1]
        return tuple(out)

    monkeypatch.setattr(dryrun, "scan_stage_a", lossy)
    with pytest.raises(RuntimeError, match="stage-A scan's valid over 4 devices differs"):
        dryrun.stage_a_step(seqs, FMIndex(bwt, ns), ["cpu"] * 4)


@pytest.mark.parametrize("num_reads", [8, 16])
def test_dryrun_reads_are_the_jax_dry_runs(num_reads):
    """The reads of `__graft_entry__.py::_tiny_problem` (seed 0, 24 bp)."""
    import __graft_entry__

    want = __graft_entry__._tiny_problem(num_reads=num_reads)[0]
    assert dryrun.tiny_reads(num_reads=num_reads) == want


def _overlapping_reads(num_reads=8, readlen=24, seed=0):
    """Reads from one short genome, so that the scan emits overlap blocks."""
    import numpy as np

    rng = np.random.default_rng(seed)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 80))
    starts = rng.integers(0, len(genome) - readlen, num_reads)
    return [genome[s : s + readlen] for s in starts]


@pytest.mark.parametrize("lost", ["emitted block", "containment candidate"])
def test_dryrun_raises_on_a_lost_block(monkeypatch, lost):
    """A sharded scanner whose views lose their first emitted block (reads
    that overlap) or containment candidate (the dry run's own reads) makes
    the dry run raise."""
    if lost == "emitted block":
        monkeypatch.setattr(dryrun, "tiny_reads", _overlapping_reads)
    collect = tfm.DualScanner.collect

    def lossy(self, handle):
        f_view, r_view = collect(self, handle)
        if self.shards is None:
            return f_view, r_view
        keep = slice(1, None)
        if lost == "emitted block":
            assert len(f_view[0]) > 0
            f_view = (f_view[0][keep], f_view[1][keep], f_view[2][keep], *f_view[3:])
        else:
            assert len(f_view[3]) > 0
            f_view = (*f_view[:3], f_view[3][keep], f_view[4][keep], f_view[5])
        return f_view, r_view

    monkeypatch.setattr(tfm.DualScanner, "collect", lossy)
    with pytest.raises(RuntimeError, match="index-sharded views over 2 shards differ"):
        dryrun.dryrun_multidevice(["cpu"] * 2)


def test_dryrun_raises_on_lost_hits(monkeypatch):
    """Hits over the device list that differ from the host path's raise."""
    from siga_tpu_torch.ops import search

    hits = search.batch_overlap_hits

    def lossy(*args):
        out = list(hits(*args))
        out[0].substring = not out[0].substring
        return out

    monkeypatch.setattr(dryrun, "batch_overlap_hits", lossy)
    with pytest.raises(RuntimeError, match="differ from the host path's"):
        dryrun.dryrun_multidevice(["cpu"] * 2)


@pytest.mark.parametrize("what", ["bwt", "perm"])
def test_dryrun_raises_on_a_wrong_symbol(monkeypatch, what):
    """An index built over the device list whose BWT differs in one symbol,
    or whose .sai permutation differs in one entry, makes the dry run raise."""
    build = dryrun.distributed_index_arrays

    def wrong(seqs, devices):
        bwt, perm, ns = build(seqs, devices)
        if what == "bwt":
            bwt = bwt.copy()
            bwt[7] = (bwt[7] % 4) + 1
        else:
            perm = perm[::-1].copy()
        return bwt, perm, ns

    monkeypatch.setattr(dryrun, "distributed_index_arrays", wrong)
    with pytest.raises(RuntimeError, match="the index built over 2 segments differs"):
        dryrun.dryrun_multidevice(["cpu"] * 2)


def test_cli(capsys):
    assert dryrun.main(["--devices", "cpu,cpu"]) == 0
    out = capsys.readouterr().out
    assert "entry on cpu: emitted (23, 8, 3)" in out and "dryrun_multidevice: OK" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.main([])


class _Worker:
    def __init__(self, argv, env):
        self.argv, self.env, self.returncode = argv, env, 0

    def poll(self):
        return 0

    def wait(self):
        return 0


@pytest.mark.parametrize(
    "extra, cards, want",
    [
        ([], 2, ["cuda:0", "cuda:1", "cuda:0"]),
        (["--device", "cuda"], 2, ["cuda:0", "cuda:1", "cuda:0"]),
        (["--device=cuda", "--no-opposite-strand"], 1, ["cuda:0"] * 3),
        (["--device", "cpu"], 2, ["cpu"] * 3),
        (["--device", "cuda:1"], 2, ["cuda:1"] * 3),
        ([], 0, ["cuda"] * 3),
    ],
    ids=["default", "cuda", "--device=cuda, one card", "cpu", "cuda:1", "no card"],
)
def test_launcher_gives_each_worker_one_card(monkeypatch, extra, cards, want):
    """On a bare `cuda` (given or the default) worker I gets `--device
    cuda:(I mod k)` of the k local cards; an explicit card or the CPU, and
    the merge, keep what was given; with no card the workers keep `cuda` and
    raise as they do without the launcher."""
    started, merged = [], []
    monkeypatch.setattr(multihost.subprocess, "Popen",
                        lambda argv, env: started.append(_Worker(argv, env)) or started[-1])
    monkeypatch.setattr(multihost.torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(cli, "main", lambda argv: merged.append(argv) or 0)
    multihost.launch_overlap_2proc("reads.fa", "reads", 30, num_processes=3, extra_args=extra)
    assert len(started) == 3 and len(merged) == 1
    for pid, (worker, device) in enumerate(zip(started, want)):
        rest, got = cli._split_device(worker.argv[4:])
        assert got == device, worker.argv
        assert rest[:4] == ["-m", "30", "-p", "reads"]
        assert rest[-5:] == ["--num-processes", "3", "--process-id", str(pid), "reads.fa"]
        assert worker.env["SIGA_PROCESS_ID"] == str(pid)
        assert [a for a in rest[4:-5]] == [a for a in cli._split_device(extra)[0]]
    assert merged[0] == ["overlap", "-m", "30", "-p", "reads", *extra, "--merge-only", "-t", "3",
                         "reads.fa"]
