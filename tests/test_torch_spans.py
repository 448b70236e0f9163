"""The program's spans (`siga_tpu_torch/spans.py`) in the device index build
(`index/sa.py`) on the CPU: nothing recorded and nothing changed without a
profiler; under a CPU `torch.profiler` one span a direction with its
children nested in the build's order (the plan, `siga.sa.sort_plan`,
after the seed); the card's plan waited for inside that span; the off
path's cost.  The wait for the card's outputs (`siga.sa.wait`) exists only
on a card: `portbench/tests` checks it there."""
import time
import timeit

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import sa_edge_reads
from siga_tpu_torch import spans
from siga_tpu_torch.index import sa

CHILDREN = ["siga.sa.check_fits", "siga.sa.pin_text", "siga.sa.seed", "siga.sa.sort_plan",
            "siga.sa.rounds", "siga.sa.to_host"]
TEXTS = ["rounds 1 (100 bp)", "rounds 3 (300 and 50)",
         "many tiles (600 x 150 bp of a 6 kb genome)"]


def _codes(label: str, reverse: bool) -> np.ndarray:
    reads = sa_edge_reads()[label]
    return sa.concat_reads([r[::-1] for r in reads] if reverse else reads)[0]


def _program_events(prof) -> list:
    """[(start, end, name)] of the program's spans in a profile, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.name.startswith("siga."))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("label", TEXTS)
def test_without_a_profiler_spans_record_nothing_and_change_nothing(label, reverse):
    codes = _codes(label, reverse)
    assert not torch.autograd._profiler_enabled()
    off = spans.span("siga.sa.build")
    assert off is spans.span("siga.sa.wait")  # one shared no-op
    with off as entered:
        assert entered is None
    bwt, perm = sa.bwt_perm_device(codes, "cpu")
    want_bwt, want_perm = sa.bwt_perm_plain(codes, "cpu")
    np.testing.assert_array_equal(bwt, want_bwt)
    np.testing.assert_array_equal(perm, want_perm)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("label", TEXTS)
def test_a_build_under_the_profiler_nests_its_spans_in_order(label, reverse):
    codes = _codes(label, reverse)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bwt, perm = sa.bwt_perm_device(codes, "cpu")
    want_bwt, want_perm = sa.bwt_perm_plain(codes, "cpu")
    np.testing.assert_array_equal(bwt, want_bwt)
    np.testing.assert_array_equal(perm, want_perm)
    events = _program_events(prof)
    builds = [e for e in events if e[2] == "siga.sa.build"]
    assert len(builds) == 1
    b0, b1, _ = builds[0]
    children = [e for e in events if e[2] != "siga.sa.build"]
    assert [name for _s, _e, name in children] == CHILDREN
    assert all(b0 <= s <= e <= b1 for s, e, _ in children)
    # siblings one after another, none inside another
    assert all(children[i][1] <= children[i + 1][0] for i in range(len(children) - 1))


def test_the_cpu_does_not_wait_and_the_card_route_alone_names_the_wait():
    codes = _codes("rounds 1 (100 bp)", False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sa.bwt_perm_device(codes, "cpu")
    names = [name for _s, _e, name in _program_events(prof)]
    assert "siga.sa.to_host" in names and "siga.sa.wait" not in names


def test_the_route_outside_a_build_keeps_its_spans_and_its_order():
    """`suffix_array_device` and `index_arrays_device` record the same steps
    with no build around them, and give the orders they gave."""
    codes = _codes("rounds 3 (300 and 50)", False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        order = sa.suffix_array_device(codes, "cpu")
    names = [name for _s, _e, name in _program_events(prof)]
    assert names == CHILDREN[:-1]
    np.testing.assert_array_equal(order.numpy(), sa.suffix_array_plain(codes, "cpu").numpy())


class _PlanEvent:
    """A card plan's event as `_plan_wait` uses it: fired or not when
    queried; its wait recorded."""

    def __init__(self, fired: bool):
        self.fired, self.waited = fired, False

    def query(self) -> bool:
        return self.fired

    def synchronize(self) -> None:
        self.waited = True


@pytest.mark.parametrize("fired", [True, False])
def test_a_card_plan_is_waited_for_inside_the_plan_span(fired):
    """The card's half of the plan on the CPU: `_plan_wait` given an event
    and the plan's numbers waits on that event inside `siga.sa.sort_plan`,
    reads the numbers as the host's `sort_plan` gives them, and counts a
    card plan, unready where its event had not fired."""
    codes = _codes("rounds 3 (300 and 50)", False)
    numbers = sa.plan_text(torch.from_numpy(codes))
    event = _PlanEvent(fired)
    before = dict(sa.plan_stats)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plan = sa._plan_wait(codes, (event, numbers))
    assert plan == sa.sort_plan(codes) and event.waited
    assert sa.plan_stats == {**before, "card": before["card"] + 1,
                             "unready": before["unready"] + (not fired)}
    assert [name for _s, _e, name in _program_events(prof)] == ["siga.sa.sort_plan"]


@pytest.mark.parametrize("codes", [np.array([0], dtype=np.uint8),
                                   np.array([1, 0], dtype=np.uint8)])
def test_texts_of_one_and_two_codes_build_under_the_profiler(codes):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bwt, perm = sa.bwt_perm_device(codes, "cpu")
    want_bwt, want_perm = sa.bwt_perm_plain(codes, "cpu")
    np.testing.assert_array_equal(bwt, want_bwt)
    np.testing.assert_array_equal(perm, want_perm)
    names = [name for _s, _e, name in _program_events(prof)]
    assert names.count("siga.sa.build") == 1 and "siga.sa.rounds" in names


def test_the_off_path_costs_under_a_microsecond_a_span():
    """10**5 calls in chunks of 1,000, each chunk timed by the thread's CPU
    clock (time the scheduler gives other processes is not the span's), the
    least chunk taken."""
    calls, chunks = 1_000, 100

    def run():
        for _ in range(calls):
            with spans.span("siga.sa.seed"):
                pass

    assert not torch.autograd._profiler_enabled()
    best = min(timeit.Timer(run, timer=time.thread_time).repeat(number=1, repeat=chunks))
    assert best / calls < 1e-6, best / calls
