"""Command-line interface of the port: `python -m siga_tpu_torch <command>`.

Option tables and parsing are `siga_tpu.cli`'s.  The port adds `--device
{cuda,cpu}` to `index`, `overlap` and `rmdup` (default cuda; the CPU runs
the plain PyTorch versions of the kernels and exists for the tests).
`assemble` is the shared jax-free command.  Commands outside the ported
slice exit with a message.
"""
from __future__ import annotations

import sys
from typing import List, Tuple

from siga_tpu import cli as shared_cli

PORTED = ("index", "overlap", "rmdup", "assemble")
ON_DEVICE = ("index", "overlap", "rmdup")


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
    if command not in shared_cli.OPTION_TABLES:
        print(shared_cli.help_text())
        return 1
    if command not in PORTED:
        print(
            f"{command}: not yet ported to siga_tpu_torch (see ROADMAP.md); "
            "run it with the JAX package (`python -m siga_tpu`)",
            file=sys.stderr,
        )
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
    if opts.get("help"):
        print(shared_cli.USAGE[command])
        if command in ON_DEVICE:
            print("      --device=cuda|cpu      device of the suffix sort (index -a sais2) "
                  "or the stage-A scan (default: cuda)")
        return 256
    if command == "index":
        from .commands import index_cmd as mod
    elif command == "overlap":
        from .commands import overlap_cmd as mod
    elif command == "rmdup":
        from .commands import rmdup_cmd as mod
    else:
        from siga_tpu.commands import assemble_cmd as mod
    return mod.run(opts, args)


if __name__ == "__main__":
    sys.exit(main())
