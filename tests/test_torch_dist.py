"""Data-parallel stage A over a list of devices (`parallel/dist.py`) and the
device guard of every kernel launch.

The engine over `[cpu] * D` (D entries that share one device's planes, the
counterpart of the JAX tests' 8-device CPU mesh) against one device, against
JAX's `batch_overlap_hits(..., mesh=data_mesh(8))` and `batch_duplicate_hits`,
and against the host engine.  Hits are integers and text: equality is exact.
"""
import ast
import contextlib
import os
import random
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from siga_tpu.index import sa as jax_sa
from siga_tpu.index.fm import FMIndex
from siga_tpu.io.fastx import DNASeq
from siga_tpu.ops import search as jax_search
from siga_tpu.overlap.builder import Hit, OverlapBuilder
from siga_tpu.parallel.dist import data_mesh
from siga_tpu_torch import kernels
from siga_tpu_torch.ops import fm_device as tfm
from siga_tpu_torch.ops import search as tsearch
from siga_tpu_torch.parallel import dist

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "siga_tpu_torch")


@pytest.fixture(scope="module")
def reads():
    """64 bp reads from both strands of a 700 bp genome, a duplicate and a
    contained read (the read set of `tests/test_dist.py`, with both strands)."""
    rng = random.Random(9)
    genome = "".join(rng.choice("ACGT") for _ in range(700))
    comp = str.maketrans("ACGT", "TGCA")
    seqs = [genome[i : i + 64] for i in range(0, 620, 12)]
    seqs = [s if k % 2 else s.translate(comp)[::-1] for k, s in enumerate(seqs)]
    return seqs + [seqs[0], seqs[3][4:60]]


def _builder(seqs, **kw):
    fwd, _p, rev, _rp, ns = jax_sa.build_index_arrays_pair(seqs, use_device=False)
    return OverlapBuilder(FMIndex(fwd, ns), FMIndex(rev, ns), **kw)


def _records(seqs):
    return [DNASeq(name=f"r{i}", seq=s) for i, s in enumerate(seqs)]


def _lines(hits):
    return [h.serialize() for h in hits]


@pytest.fixture(scope="module")
def jax_hits(reads):
    """JAX's hits over the 8-device CPU mesh, for each (rc, min_overlap)."""
    cache = {}

    def get(rc, mo):
        if (rc, mo) not in cache:
            cache[rc, mo] = _lines(jax_search.batch_overlap_hits(
                _builder(reads, rc=rc), _records(reads), mo, mesh=data_mesh(8)))
        return cache[rc, mo]

    return get


@pytest.mark.parametrize("rc, mo", [(True, 30), (False, 45)], ids=["rc -m 30", "no rc -m 45"])
@pytest.mark.parametrize("D", [2, 3, 8])
def test_overlap_hits_over_a_device_list(reads, jax_hits, D, rc, mo):
    """The engine over [cpu] x D equals one device and JAX's 8-device mesh,
    and the first reads alone (fewer than D entries for D = 8) too."""
    builder = _builder(reads, rc=rc)
    one = _lines(tsearch.batch_overlap_hits(builder, _records(reads), mo, torch.device("cpu")))
    split = _lines(tsearch.batch_overlap_hits(builder, _records(reads), mo, ["cpu"] * D))
    assert split == one == jax_hits(rc, mo)
    few = reads[:5]
    assert _lines(tsearch.batch_overlap_hits(builder, _records(few), mo, ["cpu"] * D)) == \
        _lines(tsearch.batch_overlap_hits(builder, _records(few), mo, "cpu"))


@pytest.mark.parametrize("D", [2, 3, 8])
def test_duplicate_hits_over_a_device_list(reads, D):
    """rmdup's search over [cpu] x D equals one device, JAX's mesh and the
    host engine (`OverlapBuilder.duplicate`)."""
    builder = _builder(reads)
    records = _records(reads)
    one = _lines(tsearch.batch_duplicate_hits(builder, records, "cpu"))
    split = _lines(tsearch.batch_duplicate_hits(builder, records, ["cpu"] * D))
    # a builder of its own: both engines cache their scanners on the builder
    jax = _lines(jax_search.batch_duplicate_hits(_builder(reads), records, mesh=data_mesh(8)))
    host = []
    for i, s in enumerate(reads):
        hit = Hit(idx=i)
        hit.substring = builder.duplicate(s, hit.blocks).substring
        host.append(hit.serialize())
    assert split == one == jax == host
    assert _lines(tsearch.batch_duplicate_hits(builder, records[:3], ["cpu"] * D)) == one[:3]


@pytest.mark.parametrize("pair", [True, False], ids=["pairs", "single step"])
@pytest.mark.parametrize("D", [2, 3, 8])
def test_views_join_to_the_one_device_views(reads, D, pair):
    """The joined views equal one scanner's: lanes remapped to the chunk's
    layout, blocks lane-major with t ascending, candidates ascending."""
    builder = _builder(reads)
    fm = (tfm.DeviceFM(builder.fmi, "cpu"), tfm.DeviceFM(builder.rfmi, "cpu"))
    sc = tfm.DualScanner(*fm, pair_step=pair)
    maxlen = 64
    want = sc.collect(sc.dispatch(reads, len(reads), maxlen, 25))
    got = dist.scan_views([sc] * D, reads, maxlen, 25)
    for view_a, view_b in zip(want, got, strict=True):
        for x, y in zip(view_a, view_b, strict=True):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_shard_bounds():
    assert dist.shard_bounds(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert dist.shard_bounds(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert dist.shard_bounds(0, 2) == [(0, 0), (0, 0)]


def test_device_lists():
    cpu = torch.device("cpu")
    assert dist.device_list("cpu") == [cpu]
    assert dist.device_list(["cpu", cpu]) == [cpu, cpu]
    assert dist.command_devices("cpu") == [cpu]
    with pytest.raises(ValueError, match="mixes cpu and cuda"):
        dist.device_list(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="no device"):
        dist.device_list([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dist.data_devices()
        for name in ("cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                dist.command_devices(name)


def test_engine_refuses_a_mixed_list(reads):
    builder = _builder(reads)
    with pytest.raises(ValueError, match="mixes"):
        list(tsearch.batch_overlap_hits(builder, _records(reads), 30, ["cpu", "cuda:1"]))


def test_launch_sets_the_device(monkeypatch):
    """`kernels.launch` calls the entry point with the tensors' device made
    current and its stream last, then checks and counts the launch."""
    events = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            events.append(("enter", self.device))

        def __exit__(self, *exc):
            events.append(("exit", self.device))

    monkeypatch.setattr(kernels.torch.cuda, "device", Guard)
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: f"stream of {device}")
    monkeypatch.setitem(kernels.launches, "scan_single", 0)
    dev = torch.device("cuda", 1)

    def entry(*args):
        events.append(("call", args))
        return 0

    kernels.launch("scan_single", dev, entry, 7, 8)
    assert events == [("enter", dev), ("call", (7, 8, "stream of cuda:1")), ("exit", dev)]
    assert kernels.launches["scan_single"] == 1
    def check(rc, name):
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    monkeypatch.setattr(kernels, "check", check)
    with pytest.raises(RuntimeError, match="scan_single: CUDA error 700"):
        kernels.launch("scan_single", dev, lambda *a: 700)
    assert kernels.launches["scan_single"] == 1  # a failed launch is not counted


def test_launch_counts_from_many_threads(monkeypatch):
    """The shards of a chunk launch from threads of their own: with more
    threads than cores and a short switch interval, no count is lost."""
    monkeypatch.setattr(kernels.torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "stream_ptr", lambda device: 0)
    monkeypatch.setitem(kernels.launches, "scan_single", 0)
    threads, each = 4 * (os.cpu_count() or 1), 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            futures = [pool.submit(lambda: [kernels.launch("scan_single", "cuda:0", lambda s: 0)
                                            for _ in range(each)]) for _ in range(threads)]
            for f in futures:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launches["scan_single"] == threads * each


def test_every_entry_point_launches_through_the_guard():
    """Every C entry point that launches a kernel (the ones that take a
    stream) is named only as the entry of a `kernels.launch(name, device,
    entry, ...)` call, or bound by `functools.partial` for
    `fm_device.CardScan`, which launches it through `kernels.launch`:
    so every launch runs under the device of its tensors."""
    entries = {name for name, sig in kernels._SIGNATURES.items() if sig and sig[-1] is kernels._P}
    assert {"siga_scan_pair", "siga_scan_single", "siga_pair_plane", "siga_kmer_count",
            "siga_sw_wavefront", "siga_gather_rows", "siga_take_along",
            "siga_gather_chain_sum", "siga_gather_chain_elem", "siga_scale2"} <= entries
    seen, direct = set(), []
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_build")]
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            guarded = set()
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "launch":
                    for arg in node.args[2:3]:
                        if isinstance(arg, ast.Attribute):
                            guarded.add(id(arg))
                if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "partial":
                    for arg in node.args[:1]:
                        if isinstance(arg, ast.Attribute):
                            guarded.add(id(arg))
            for node in ast.walk(tree):
                if isinstance(node, ast.Attribute) and node.attr in entries:
                    seen.add(node.attr)
                    if id(node) not in guarded:
                        direct.append(f"{os.path.relpath(path, PORT)}:{node.lineno} {node.attr}")
    assert not direct, direct
    assert seen == entries
