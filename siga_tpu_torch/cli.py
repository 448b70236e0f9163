"""Command-line interface of the port: `python -m siga_tpu_torch <command>`.

Option tables and parsing are `siga_tpu.cli`'s.  The port adds `--device
{cuda,cpu}` to `index`, `correct`, `overlap` and `rmdup` (default cuda; the
CPU runs the plain PyTorch versions of the kernels and exists for the
tests).  `preprocess`, `assemble`, `subgraph`, `match`, `preqc` and `gan`
are the shared jax-free commands of `siga_tpu`.  Each device command prints
the launches of each kernel it ran on stderr, for a parent process to read.
Only code that reaches the device imports torch, so the shared commands and
`correct`'s host routes start without it.
"""
from __future__ import annotations

import importlib
import json
import sys
from typing import List, Tuple

from siga_tpu import cli as shared_cli

from .device import native_lib

MODULES = {
    "preprocess": "siga_tpu.commands.preprocess",
    "index": "siga_tpu_torch.commands.index_cmd",
    "correct": "siga_tpu_torch.commands.correct_cmd",
    "overlap": "siga_tpu_torch.commands.overlap_cmd",
    "assemble": "siga_tpu.commands.assemble_cmd",
    "rmdup": "siga_tpu_torch.commands.rmdup_cmd",
    "subgraph": "siga_tpu.commands.subgraph_cmd",
    "match": "siga_tpu.commands.match_cmd",
    "preqc": "siga_tpu.commands.preqc_cmd",
    "gan": "siga_tpu.commands.gan_cmd",
}
PORTED = tuple(MODULES)
ON_DEVICE = ("index", "correct", "overlap", "rmdup")
DEVICE_HELP = {
    "index": "device of the suffix sort (index -a sais2)",
    "correct": "device of the k-mer counter K7, which --engine=auto|tpu runs "
               "when the index is not the reads' own",
    "overlap": "device of the stage-A scan (--engine=auto|tpu)",
    "rmdup": "device of the stage-A scan",
}


def _split_device(argv: List[str]) -> Tuple[List[str], str]:
    """Remove `--device X` / `--device=X` (before a `--`) from argv."""
    rest, device, i = [], "cuda", 0
    while i < len(argv):
        a = argv[i]
        if a == "--":
            rest.extend(argv[i:])
            break
        if a == "--device":
            if i + 1 == len(argv):
                raise ValueError("--device needs a value (cuda or cpu)")
            device = argv[i + 1]
            i += 2
            continue
        if a.startswith("--device="):
            device = a[len("--device="):]
        else:
            rest.append(a)
        i += 1
    return rest, device


def main(argv: List[str] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(shared_cli.help_text())
        print(f"\nPorted to PyTorch/CUDA: {', '.join(PORTED)}")
        return 0 if argv else 1
    command = argv[0]
    if command not in MODULES:
        print(shared_cli.help_text())
        return 1
    args = argv[1:]
    device = None
    if command in ON_DEVICE:
        args, device = _split_device(args)
    opts, args = shared_cli.parse_options(command, args)
    if device is not None:
        opts["device"] = device

    from siga_tpu.core import logconf

    logconf.configure(opts.get("log4cxx"))
    mod = importlib.import_module(MODULES[command])
    if opts.get("help"):
        print(shared_cli.USAGE[command])
        if command in ON_DEVICE:
            print(f"      --device=cuda|cpu      {DEVICE_HELP[command]} (default: cuda)")
        return 256
    # every command, the shared ones too, runs on the port's host build of
    # the C++ runtime and not on the library tracked beside its sources
    native_lib()
    if command not in ON_DEVICE:
        return mod.run(opts, args)
    before = dict(_launches())
    rc = mod.run(opts, args)
    # what a parent process reads to see which kernels this command ran
    ran = {name: n - before.get(name, 0) for name, n in _launches().items()
           if n != before.get(name, 0)}
    print(f"[{command}] kernel launches: {json.dumps(ran)}", file=sys.stderr)
    return rc


def _launches() -> dict:
    """The kernels' launch counts so far; empty while `kernels` is not
    imported (a command that reaches no device code imports no torch)."""
    kernels = sys.modules.get(f"{__package__}.kernels")
    return kernels.launches if kernels is not None else {}


if __name__ == "__main__":
    sys.exit(main())
