"""The harness: a cell of BENCHMARK.json run on one device.

Everything of a cell is found by name: its configuration
(`configs/<config>.json`, as BENCHMARK.json's `configs` names the file),
its traffic mix (`traffic/<traffic>.json`), the entry that the mix names
(`entries/<entry>.py`: the program's call a unit of work makes, its
set-up and its check) and a reader for each of its metrics
(`metrics/<name>.py`).  A later cell, mix, configuration or metric is new
files and new entries in BENCHMARK.json.

A run: set-up (the entry makes the inputs from the seed, builds the
program's state and warms up with one unit), then the measured window, a
closed loop of units until `seconds` have passed (under `torch.profiler`
with a span around each unit where `trace`), then the check against the
plain reference once the program's state is freed, then the readings.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time
from contextlib import nullcontext

from .trace import SPAN, Trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = ("jax", "jaxlib", "flax", "siga_tpu")  # top-level module names, whole


def load_benchmark(path: str = os.path.join(ROOT, "BENCHMARK.json")) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(items, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    """The configuration `name` from the file BENCHMARK.json gives it."""
    with open(os.path.join(root, _named(bench["configs"], name, "configuration")["file"])) as f:
        return json.load(f)


def traffic(name: str, here: str = HERE) -> dict:
    with open(os.path.join(here, "traffic", f"{name}.json")) as f:
        return json.load(f)


def entry(name: str):
    return importlib.import_module(f"portbench.entries.{name}")


def reader(name: str, here: str = HERE):
    """The `read` function of `metrics/<name>.py`."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The metrics of `kind` (end_to_end or per_layer) a cell reports: those
    that list it, or list no cells."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def banned_modules() -> list:
    """The JAX package and JAX's modules that this process has loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
        return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
        start: float, root: str = ROOT) -> dict:
    """One run of the cell `name` of `bench` (loaded from `root`): the
    result's fields, and under "compared" {name: {"value", "limit"}}."""
    import torch

    cell = workload(bench, name)
    mix = traffic(cell["traffic"])
    on_card = device.type == "cuda"
    cfg = config(bench, cell["config"], root)
    c = entry(mix["entry"]).Cell(cfg, mix, seed, device, seconds)
    if on_card:
        torch.cuda.synchronize(device)
        peak_setup = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - start

    prof = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
    use0 = resource.getrusage(resource.RUSAGE_SELF)
    with prof if prof is not None else nullcontext():
        units = 0
        t0 = time.perf_counter()
        ends = []
        while True:
            with torch.profiler.record_function(SPAN) if prof is not None else nullcontext():
                out = c.unit()
            c.keep(units, out)
            units += 1
            del out
            ends.append(time.perf_counter())
            if ends[-1] - t0 >= seconds:
                break
        window_s = ends[-1] - t0
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    cpu_s = (use1.ru_utime + use1.ru_stime - use0.ru_utime - use0.ru_stime) / units

    peak_window = torch.cuda.max_memory_allocated(device) if on_card else 0
    counters = c.counters()
    t = Trace.from_profile(prof) if prof is not None else None
    del prof
    c.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    compared, failed = c.check()

    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    ctx = {"units": units, "window_s": window_s, "setup_s": setup_s, "work": c.work,
           "least_bytes": c.least_bytes, "kind": kind, "trace": t,
           "counters": counters, "peak_window_bytes": peak_window}
    values = {}
    for m in metrics_of(bench, name, "per_layer" if trace else "end_to_end"):
        v = reader(m["name"])(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell["chips"],
           "memory_peak_bytes": max(peak_setup, peak_window) if on_card else 0}
    result = {"correct": all(v <= limit for _n, v, limit in compared), "attempted": units,
              "failed": failed, "metrics": values, "device": dev}
    if t is not None:
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
    unit_s = sorted(b - a for a, b in zip([t0] + ends, ends))
    print(f"[portbench] {name}: seed {seed}, {units} units in {window_s} s (a unit: min "
          f"{unit_s[0]}, median {unit_s[len(unit_s) // 2]}, max {unit_s[-1]} s), set-up "
          f"{setup_s} s, counters {counters}, host CPU a unit {cpu_s} s (all threads), card "
          f"{card_line() if on_card else 'none'}", file=sys.stderr)
    result["compared"] = {n: {"value": v, "limit": limit} for n, v, limit in compared}
    return result


def finish(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error, then the result as the last line of standard output."""
    for n, v in result["compared"].items():
        print(f"compared {n} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
