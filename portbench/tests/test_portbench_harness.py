"""The harness on the CPU: finding a cell's parts by name, the generators,
the roofline counts, the trace reduction, the refusal without a card, and
whole runs at small sizes through the port's plain versions, sound and
with the timed path broken underneath."""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import generate, harness
from portbench.roofline import bytes as roofline_bytes
from portbench.trace import HOST_COPIES, Trace
from portbench.tests.conftest import SMALL_READS

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_parts_by_name(name):
    cell = harness.workload(BENCH, name)
    cfg = harness.config(BENCH, cell["config"])
    assert cfg["name"] == cell["config"] and cfg["reduced"] == []
    mix = harness.traffic(cell["traffic"])
    assert hasattr(harness.entry(mix["entry"]), "Cell")
    for kind in ("end_to_end", "per_layer"):
        metrics = harness.metrics_of(BENCH, name, kind)
        assert metrics
        for m in metrics:
            assert callable(harness.reader(m["name"]))
    assert "setup_s" in [m["name"] for m in harness.metrics_of(BENCH, name, "end_to_end")]


def test_a_new_configuration_mix_and_metric_are_found_as_new_files(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "configs" / "new-deployment.json").write_text(
        json.dumps({"name": "x", "genome_bp": 7}))
    (tmp_path / "traffic" / "new-mix.json").write_text(json.dumps({"entry": "index"}))
    (tmp_path / "metrics" / "new_metric.cell.py").write_text("def read(ctx):\n    return 3\n")
    bench = {"configs": BENCH["configs"] + [{"name": "new-deployment",
                                             "file": "configs/new-deployment.json"}]}
    assert harness.config(bench, "new-deployment", root=str(tmp_path))["genome_bp"] == 7
    assert harness.traffic("new-mix", here=str(tmp_path))["entry"] == "index"
    assert harness.reader("new_metric.cell", here=str(tmp_path))({}) == 3
    assert harness.config(bench, "saureus-usa300-gage")["read_length"] == 101


def test_a_metric_without_cells_is_every_cells():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["c1"]}]}
    assert [m["name"] for m in harness.metrics_of(bench, "c1", "end_to_end")] == ["a", "b"]
    assert [m["name"] for m in harness.metrics_of(bench, "c2", "end_to_end")] == ["a"]


def test_reads_repeat_from_their_seed_and_keep_their_sizes():
    a, b = generate.reads(SMALL_READS, 2**33 + 1), generate.reads(SMALL_READS, 2**33 + 1)
    c = generate.reads(SMALL_READS, 5)
    assert np.array_equal(a, b) and a.shape == c.shape and not np.array_equal(a, c)
    assert a.shape == (generate.read_count(SMALL_READS), 101)
    assert a.min() >= 1 and a.max() <= 4
    t = generate.text(a)
    assert t.size == a.size + a.shape[0] and (t == 0).sum() == a.shape[0] and t[-1] == 0
    assert np.array_equal(generate.text(a, reverse=True).reshape(-1, 102)[:, :101], a[:, ::-1])


def test_the_cells_read_counts_are_the_configurations():
    assert generate.read_count(harness.config(BENCH, "saureus-usa300-gage")) == 1293452


def test_roofline_bytes_by_hand():
    assert roofline_bytes.index_build(10, 2) == 2 * 10 + 8 * 2
    # saureus: both directions of 1,293,452 reads of 101 bp
    assert 2 * roofline_bytes.index_build(131932104, 1293452) == 548423648
    assert roofline_bytes.least_ms("NVIDIA H100 80GB HBM3", 3.35e9) == pytest.approx(1.0)
    assert roofline_bytes.least_ms("some other card", 1) is None


def test_the_trace_reduction():
    spans = [(0.0, 100.0), (100.0, 300.0)]
    device = [(10.0, 30.0, "k1"), (20.0, 40.0, "k2"), (150.0, 250.0, "k1"), (290.0, 400.0, "k3"),
              (5.0, 12.0, "Memcpy HtoD (Pinned -> Device)"), (260.0, 270.0, "Memcpy DtoD"),
              (270.0, 285.0, "Memcpy DtoH (Device -> Pinned)")]
    host = [(0.0, 5.0, "aten::copy_"), (40.0, 140.0, "aten::sort")]
    t = Trace(spans, device, host)
    assert t.window_s == pytest.approx(300e-6)
    assert t.busy_s == pytest.approx((35 + 100 + 10 + 25) * 1e-6)
    assert t.span_busy_s() == pytest.approx([35e-6, 135e-6])
    # without the copies over PCIe; the copy on the card stays
    assert t.span_busy_s(skip=HOST_COPIES) == pytest.approx([30e-6, 120e-6])
    assert t.span_host_s() == pytest.approx([65e-6, 65e-6])
    assert t.top_ops()[0] == ["k1", pytest.approx(120e-6)]
    gaps = t.idle_gaps()
    outside = "host code outside torch operations"
    assert [g[0] for g in gaps] == ["aten::sort", outside, "aten::copy_", outside]
    assert [g[1] for g in gaps] == pytest.approx([110e-6, 10e-6, 5e-6, 5e-6])


def test_readers_find_nothing_without_a_trace():
    ctx = {"trace": None, "least_bytes": {}, "counters": {}, "kind": "cpu"}
    for m in BENCH["per_layer"]:
        if m["source"] == "device_trace" or m["source"] == "program_span":
            assert harness.reader(m["name"])(ctx) is None, m["name"]


def test_the_run_command_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    # a checkout that holds only BENCHMARK.json and the harness
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def small_run(root, name: str, trace: bool = False) -> dict:
    """A run of the cell `name` in a checkout of its own under `root`: its
    BENCHMARK.json, with every configuration cut to SMALL_READS."""
    (root / "BENCHMARK.json").write_text(json.dumps(BENCH))
    for c in BENCH["configs"]:
        path = root / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dict(harness.config(BENCH, c["name"]), **SMALL_READS)))
    bench = harness.load_benchmark(str(root / "BENCHMARK.json"))
    return harness.run(bench, name, 2**32 + 11, 0.0, trace, torch.device("cpu"), time.time(),
                       root=str(root))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_small_run_is_correct(name, tmp_path, capsys):
    result = small_run(tmp_path, name, trace=True)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "compared"
    assert all(v["value"] == 0 for v in result["compared"].values())
    harness.finish(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True
    assert err.strip().splitlines()[-1].startswith("compared ")


# Faults planted under the timed path: each must make `correct` false.

def _index_fault(kind):
    from siga_tpu_torch.index import sa

    build = sa.bwt_perm_device

    def broken(codes, device):
        if kind == "unchanged":  # the text comes back as it went in
            return codes.copy(), np.arange(int((codes == 0).sum()))
        if kind == "half":  # the second half of the reads left out
            half = np.flatnonzero(codes == 0)[(codes == 0).sum() // 2 - 1] + 1
            return build(codes[:half], device)
        bwt, perm = build(codes, device)  # one symbol altered where it is made
        bwt = bwt.copy()
        bwt[len(bwt) // 3] = bwt[len(bwt) // 3] % 4 + 1
        return bwt, perm
    return sa, "bwt_perm_device", broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_under_the_timed_path_makes_the_run_incorrect(name, kind, tmp_path, monkeypatch):
    module, attr, broken = _index_fault(kind)
    monkeypatch.setattr(module, attr, broken)
    result = small_run(tmp_path, name)
    assert result["correct"] is False and result["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in result["compared"].values())


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_correct_on_the_card(name, card):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name,
                          "--seed", "2147483999", "--seconds", "2", "--trace", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
