"""The program's spans in the benchmark: the trace reduction keeps them as
host operations and reads every other number as it did, names the idle gaps
by them, and the readers of the host's plan, staging, waits and free-memory
check read them; on the card, one wait a direction."""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import generate, harness, program
from portbench.tests.conftest import SMALL_READS
from portbench.tests.test_portbench_harness import small_run
from portbench.trace import HOST_COPIES, SPAN, Trace

BENCH = harness.load_benchmark()
CELL = "saureus-gage.index"
NEW = ["plan_ms.index", "plan_idle_ms.index", "stage_ms.index", "wait_ms.index", "fits_ms.index"]
OLD = [m["name"] for m in BENCH["per_layer"] if m["name"] not in NEW]


def innermost(gap_name: str) -> str:
    """The innermost program span a gap's name carries."""
    return [p for p in gap_name.split(" > ") if p.startswith(program.PREFIX)][-1]


def test_the_reduction_with_program_spans_reads_as_without():
    """The trace reduction's hand-made trace (`test_the_trace_reduction`)
    with program spans among the host's operations: the same busy time,
    span times and top operations; each gap named by the innermost program
    span that covers half of it."""
    spans = [(0.0, 100.0), (100.0, 300.0)]
    device = [(10.0, 30.0, "k1"), (20.0, 40.0, "k2"), (150.0, 250.0, "k1"), (290.0, 400.0, "k3"),
              (5.0, 12.0, "Memcpy HtoD (Pinned -> Device)"), (260.0, 270.0, "Memcpy DtoD"),
              (270.0, 285.0, "Memcpy DtoH (Device -> Pinned)")]
    host = [(0.0, 5.0, "aten::copy_"), (40.0, 140.0, "aten::sort")]
    ours = [(0.0, 100.0, "siga.sa.build"), (0.0, 6.0, "siga.sa.pin_text"),
            (35.0, 100.0, "siga.sa.sort_plan"), (100.0, 300.0, "siga.sa.build"),
            (245.0, 290.0, "siga.sa.to_host"), (262.0, 284.0, "siga.sa.wait")]
    before, t = Trace(spans, device, host), Trace(spans, device, host + ours)
    assert t.busy == before.busy and t.busy_s == before.busy_s
    assert t.window_s == before.window_s
    assert t.span_busy_s() == before.span_busy_s()
    assert t.span_busy_s(skip=HOST_COPIES) == before.span_busy_s(skip=HOST_COPIES)
    assert t.span_host_s() == before.span_host_s()
    assert t.top_ops() == before.top_ops()
    assert sorted(program.spans(t)) == sorted(ours)
    gaps, old = t.idle_gaps(), before.idle_gaps()
    assert [g[1] for g in gaps] == [g[1] for g in old]
    assert [innermost(g[0]) for g in gaps] == ["siga.sa.sort_plan", "siga.sa.to_host",
                                               "siga.sa.pin_text", "siga.sa.to_host"]
    assert gaps[2][0] == "siga.sa.build > siga.sa.pin_text > aten::copy_"


def _event(name, start, end, device, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=device, is_user_annotation=annotation)


def test_a_profile_keeps_program_spans_on_the_host_and_off_the_device():
    """Through `Trace.from_profile`: the program's spans are host
    operations; a copy of an annotation on the device is not busy time."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [_event(SPAN, 0.0, 100.0, cpu, True), _event(SPAN, 0.0, 100.0, cuda, True),
              _event("siga.sa.build", 1.0, 99.0, cpu),
              _event("siga.sa.build", 1.0, 99.0, cuda, True),
              _event("siga.sa.sort_plan", 40.0, 90.0, cpu),
              _event("k1", 10.0, 30.0, cuda), _event("cudaLaunchKernel", 9.0, 10.0, cpu)]
    t = Trace.from_profile(SimpleNamespace(events=lambda: events))
    assert t.spans == [(0.0, 100.0)]
    assert t.device == [(10.0, 30.0, "k1")] and t.busy == [[10.0, 30.0]]
    assert program.spans(t) == [(1.0, 99.0, "siga.sa.build"), (40.0, 90.0, "siga.sa.sort_plan")]
    assert innermost(t.idle_gaps()[0][0]) == "siga.sa.sort_plan"


def _two_builds() -> Trace:
    """Two units, each a build with every child span; the device busy in
    the seed's sorts, and once inside the first plan.  Times in us."""
    spans = [(0.0, 1000.0), (1000.0, 2000.0)]
    device = [(100.0, 300.0, "k"), (400.0, 450.0, "k"), (1100.0, 1300.0, "k")]
    ours = []
    for base, steps in ((0.0, [10, 20, 60, 100, 500, 520, 890, 900, 530, 850]),
                        (1000.0, [10, 15, 50, 100, 400, 410, 880, 900, 420, 800])):
        fits, pin, seed, plan, rounds, host, end, build_end, w0, w1 = (base + s for s in steps)
        ours += [(fits, build_end, "siga.sa.build"), (fits, pin, "siga.sa.check_fits"),
                 (pin, seed, "siga.sa.pin_text"), (seed, plan, "siga.sa.seed"),
                 (plan, rounds, "siga.sa.sort_plan"), (rounds, host, "siga.sa.rounds"),
                 (host, end, "siga.sa.to_host"), (w0, w1, "siga.sa.wait")]
    ours.append((-100.0, -10.0, "siga.sa.build"))  # before the window: no unit's
    return Trace(spans, device, ours)


# by hand from `_two_builds` (ms): plans 400 and 300 us; idle in them 150
# (400 less 200 and 50 busy) and 100; staging 40 + 370 - 320 and 35 + 470 -
# 380; waits 320 and 380; checks 10 and 5
BY_HAND = {"plan_ms.index": 0.35, "plan_idle_ms.index": 0.125, "stage_ms.index": 0.1075,
           "wait_ms.index": 0.35, "fits_ms.index": 0.0075}


def _ctx(trace) -> dict:
    return {"trace": trace, "least_bytes": {"sa": 3.35e9}, "counters": {},
            "kind": "NVIDIA H100 80GB HBM3", "peak_window_bytes": 2**30}


@pytest.mark.parametrize("name", NEW)
def test_each_new_reader_on_a_hand_made_trace(name, capsys):
    assert harness.reader(name)(_ctx(_two_builds())) == pytest.approx(BY_HAND[name])
    if name == "plan_idle_ms.index":  # the idle time of a build by its spans
        err = capsys.readouterr().err
        # 890 us a build less 250 and 200 busy; the children leave 10 and 20 us
        assert "inside siga.sa.build 0.665 ms" in err and "outside them 0.015" in err


@pytest.mark.parametrize("name", NEW)
def test_each_new_reader_finds_nothing_without_the_programs_spans(name):
    t = _two_builds()
    parent = Trace(t.spans, t.device, [h for h in t.host if not h[2].startswith("siga.")])
    assert harness.reader(name)(_ctx(None)) is None
    assert harness.reader(name)(_ctx(parent)) is None


@pytest.mark.parametrize("name", OLD)
def test_every_accepted_per_layer_metric_reads_as_without_the_programs_spans(name):
    """On the hand-made builds and on a recorded CPU trace of two builds."""
    t = _two_builds()
    parent = Trace(t.spans, t.device, [h for h in t.host if not h[2].startswith("siga.")])
    read = harness.reader(name)
    assert read(_ctx(t)) == read(_ctx(parent))

    rows = generate.reads(SMALL_READS, 2**32 + 7)
    texts = [generate.text(rows, reverse=r) for r in (False, True)]
    from siga_tpu_torch.index import sa

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with torch.profiler.record_function(SPAN):
                for codes in texts:
                    sa.bwt_perm_device(codes, "cpu")
    recorded = Trace.from_profile(prof)
    ours = program.spans(recorded)
    assert [n for _s, _e, n in ours].count("siga.sa.build") == 4
    bare = Trace(recorded.spans, recorded.device,
                 [h for h in recorded.host if not h[2].startswith("siga.")])
    assert read(_ctx(recorded)) == read(_ctx(bare))


def test_a_sound_small_run_reports_the_new_metrics(tmp_path, capsys):
    result = small_run(tmp_path, CELL, trace=True)
    assert result["correct"]
    metrics = result["metrics"]
    assert set(NEW) <= set(metrics)
    assert all(metrics[n]["unit"] == "ms" and metrics[n]["value"] >= 0 for n in NEW)
    assert metrics["wait_ms.index"]["value"] == 0  # the CPU does not wait
    # on the CPU the device never runs: the whole plan is idle
    assert metrics["plan_idle_ms.index"]["value"] == pytest.approx(
        metrics["plan_ms.index"]["value"])
    assert "device idle a build" in capsys.readouterr().err
    json.dumps(result)


@pytest.mark.card
def test_the_card_waits_once_a_direction(card):
    from siga_tpu_torch.index import sa

    rows = generate.reads(SMALL_READS, 2147483999)
    texts = [generate.text(rows, reverse=r) for r in (False, True)]
    want = [sa.bwt_perm_plain(codes, "cpu") for codes in texts]
    for codes in texts:  # built and warm
        sa.bwt_perm_device(codes, card)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(SPAN):
            got = [sa.bwt_perm_device(codes, card) for codes in texts]
    for (bwt, perm), (want_bwt, want_perm) in zip(got, want):
        np.testing.assert_array_equal(bwt, want_bwt)
        np.testing.assert_array_equal(perm, want_perm)
    t = Trace.from_profile(prof)
    ours = sorted(program.spans(t))
    names = [n for _s, _e, n in ours]
    assert names.count("siga.sa.build") == 2 and names.count("siga.sa.wait") == 2
    for s, e, _n in [o for o in ours if o[2] == "siga.sa.wait"]:
        assert any(hs <= s and e <= he for hs, he, hn in ours if hn == "siga.sa.to_host")
    assert t.busy and not any(d[2].startswith(program.PREFIX) for d in t.device)
    metrics = {n: harness.reader(n)({"trace": t}) for n in NEW}
    assert all(v is not None for v in metrics.values()) and metrics["wait_ms.index"] > 0
