"""Multi-process runtime for the overlap worker and merge modes.

Port of `siga_tpu/parallel/multihost.py`.  The FM-index is replicated in
every process, the reads are sharded round-robin, and process I writes
exactly the hits shard `{prefix}-threadI.hits.gz` that a single-process
`overlap -t N` run writes for its residue class; `overlap --merge-only -t N`
then emits the ASQG, byte-identical to the single-process run.  The
processes meet at one barrier of `torch.distributed` over the gloo backend
(a barrier moves no tensors), set up from the JAX package's environment:
SIGA_COORDINATOR (host:port of process 0's TCP store), SIGA_NUM_PROCESSES
and SIGA_PROCESS_ID.  On one machine the launcher gives each worker its share
of the cores and, on `--device cuda`, one card of its own.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

import torch
import torch.distributed as dist

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialise the gloo process group from the arguments or the SIGA_*
    environment.  Returns True when a multi-process group was set up, False
    when the coordination info is incomplete (a single-process run)."""
    coordinator = coordinator or os.environ.get("SIGA_COORDINATOR")
    num_processes = num_processes or _env_int("SIGA_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("SIGA_PROCESS_ID")
    if not coordinator or num_processes is None or process_id is None:
        return False
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
    )
    return True


def barrier(name: str = "siga") -> None:
    """Global barrier across the processes; a no-op in a single-process run.
    `name` labels the barrier in the error a failed one raises."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        try:
            dist.barrier()
        except RuntimeError as e:
            raise RuntimeError(f"barrier {name!r} failed: {e}") from e


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_overlap_2proc(
    input_path: str,
    prefix: str,
    min_overlap: int,
    num_processes: int = 2,
    coordinator_port: int = 0,
    extra_args: Optional[List[str]] = None,
) -> None:
    """Run `overlap` sharded over `num_processes` local worker processes
    (`python -m siga_tpu_torch overlap --process-id I --num-processes N`,
    each joining the gloo group over a local TCP store), then merge the
    shards in this process (`overlap --merge-only -t N`).  On a cluster the
    same thing is N worker invocations (one per machine, shared
    filesystem) and one merge.  A worker that fails stops the others and
    raises; there is no single-process fallback.

    Where the device is bare `cuda` (given or the default), worker I runs
    on card I mod k of the k local cards, not on all k: each worker already
    holds a share of the cores.  Another device, and the merge, are passed
    on as given; with no card the workers raise as `--device cuda` does."""
    from .. import cli

    coordinator = f"127.0.0.1:{coordinator_port or _free_port()}"
    args = ["-m", str(min_overlap), "-p", prefix] + (extra_args or [])
    rest, device = cli._split_device(extra_args or [])
    cards = torch.cuda.device_count() if device == "cuda" else 0

    def worker_args(pid):
        if cards == 0:
            return args
        return ["-m", str(min_overlap), "-p", prefix, *rest, "--device", f"cuda:{pid % cards}"]

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (PACKAGE_ROOT, env.get("PYTHONPATH")) if p
    )
    env.update(SIGA_COORDINATOR=coordinator, SIGA_NUM_PROCESSES=str(num_processes))
    # each worker gets its share of the cores: N processes of one OpenMP
    # thread per core each (the native stage B/C, torch's CPU ops) spin
    # against each other and run many times slower
    env.setdefault("OMP_NUM_THREADS", str(max(1, len(os.sched_getaffinity(0)) // num_processes)))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "siga_tpu_torch", "overlap", *worker_args(pid),
             "--num-processes", str(num_processes), "--process-id", str(pid), input_path],
            env={**env, "SIGA_PROCESS_ID": str(pid)},
        )
        for pid in range(num_processes)
    ]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
        failed = {pid: p.returncode for pid, p in enumerate(procs) if p.returncode not in (None, 0)}
        if failed:
            raise RuntimeError(f"overlap workers failed (process id: exit code): {failed}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    rc = cli.main(["overlap", *args, "--merge-only", "-t", str(num_processes), input_path])
    if rc != 0:
        raise RuntimeError(f"overlap --merge-only exited {rc}")
