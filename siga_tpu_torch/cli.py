"""Command-line interface of the port: `python -m siga_tpu_torch <command>`.

The option tables, `parse_options`, `help_text` and `USAGE` are a copy of
`siga_tpu/cli.py`'s (git-style subcommand dispatch, per-command getopt
tables, `--ini` config file merged under CLI options, repeated flags
concatenated with ':').  The port adds `--device {cuda,cpu}` to `index`,
`correct`, `overlap` and `rmdup` (default cuda; the CPU runs the plain
PyTorch versions of the kernels and exists for the tests).  Each device
command prints the launches of each kernel it ran on stderr, for a parent
process to read.  Only code that reaches the device imports torch, so the
host-only commands and `correct`'s host routes start without it.
"""
from __future__ import annotations

import configparser
import getopt
import importlib
import json
import sys
from typing import Dict, List, Tuple

from .constants import COMMAND_RANKS
from .device import native_lib

# command -> (shortopts, [(long, has_arg, short_alias)])
OPTION_TABLES: Dict[str, Tuple[str, List[Tuple[str, bool, str]]]] = {
    "preprocess": (
        "c:s:o:p:q:f:m:h",
        [
            ("log4cxx", True, "c"),
            ("ini", True, "s"),
            ("out", True, "o"),
            ("pe-mode", True, ""),
            ("pe-orientation", True, ""),
            ("with-index", False, ""),
            ("phred64", False, ""),
            ("quality-trim", True, "q"),
            ("quality-filter", True, "f"),
            ("min-length", True, "m"),
            ("hard-clip", True, ""),
            ("sample-rate", True, ""),
            ("no-primer-check", False, ""),
            ("seed", True, ""),
            ("help", False, "h"),
        ],
    ),
    "index": (
        "c:s:a:t:p:g:h",
        [
            ("log4cxx", True, "c"),
            ("ini", True, "s"),
            ("prefix", True, "p"),
            ("threads", True, "t"),
            ("algorithm", True, "a"),
            ("no-reverse", False, ""),
            ("no-forward", False, ""),
            ("help", False, "h"),
        ],
    ),
    "correct": (
        "c:s:p:t:a:k:x:o:h",
        [
            ("log4cxx", True, "c"),
            ("ini", True, "s"),
            ("prefix", True, "p"),
            ("threads", True, "t"),
            ("algorithm", True, "a"),
            ("kmer-size", True, "k"),
            ("kmer-threshold", True, "x"),
            ("kmer-rounds", True, ""),
            ("kmer-count-offset", True, ""),
            ("out", True, "o"),
            ("engine", True, ""),
            ("help", False, "h"),
        ],
    ),
    "overlap": (
        "c:s:t:p:m:xh",
        [
            ("log4cxx", True, "c"),
            ("ini", True, "s"),
            ("prefix", True, "p"),
            ("threads", True, "t"),
            ("batch-size", True, ""),
            ("min-overlap", True, "m"),
            ("exhaustive", False, "x"),
            ("no-opposite-strand", False, ""),
            ("engine", True, ""),
            ("process-id", True, ""),
            ("num-processes", True, ""),
            ("merge-only", False, ""),
            ("help", False, "h"),
        ],
    ),
    "assemble": (
        "c:s:p:t:m:x:n:C:l:A:a:d:N:G:T:h",
        [
            ("log4cxx", True, "c"),
            ("ini", True, "s"),
            ("prefix", True, "p"),
            ("min-overlap", True, "m"),
            ("max-edges", True, ""),
            ("threads", True, "t"),
            ("batch-size", True, ""),
            ("pe-mode", True, ""),
            ("with-index", False, ""),
            ("max-distance", True, ""),
            ("insert-size", True, ""),
            ("insert-size-delta", True, ""),
            ("cut-terminal", True, "x"),
            ("min-branch-length", True, "n"),
            ("min-branch-coverage", True, "C"),
            ("max-overlap-delta", True, "d"),
            ("max-overlap-carefully", False, ""),
            ("min-chimeric-length", True, "l"),
            ("min-chimeric-coverage", True, "A"),
            ("max-chimeric-delta", True, "a"),
            ("num-reads", True, "N"),
            ("genome-size", True, "G"),
            ("uniq-threshold", True, "T"),
            ("ai-model", True, "M"),
            ("max-search-nodes", True, ""),
            ("min-linkedread-length", True, ""),
            ("min-linkedread-coverage", True, ""),
            ("help", False, "h"),
        ],
    ),
    "rmdup": (
        "c:s:t:p:d:h",
        [
            ("log4cxx", True, "c"),
            ("ini", True, "s"),
            ("prefix", True, "p"),
            ("threads", True, "t"),
            ("sample-rate", True, "d"),
            ("help", False, "h"),
        ],
    ),
    "subgraph": (
        "o:m:h",
        [
            ("out", True, "o"),
            ("min-overlap", True, "m"),
            ("size", True, ""),
            ("max-edges", True, ""),
            ("help", False, "h"),
        ],
    ),
    "match": (
        "c:s:p:t:l:h",
        [
            ("log4cxx", True, "c"),
            ("ini", True, "s"),
            ("prefix", True, "p"),
            ("threads", True, "t"),
            ("max-length", True, "l"),
            ("no-opposite-strand", False, ""),
            ("help", False, "h"),
        ],
    ),
    "preqc": (
        "c:s:o:t:h",
        [
            ("log4cxx", True, "c"),
            ("ini", True, "s"),
            ("prefix", True, "o"),
            ("threads", True, "t"),
            ("simple", False, ""),
            ("sample-rate", True, ""),
            ("kmer", True, ""),
            ("seed", True, ""),
            ("help", False, "h"),
        ],
    ),
    "gan": (
        "c:s:p:t:m:h",
        [
            ("log4cxx", True, "c"),
            ("ini", True, "s"),
            ("prefix", True, "p"),
            ("threads", True, "t"),
            ("min-overlap", True, "m"),
            ("ref", True, ""),
            ("rounds", True, ""),
            ("help", False, "h"),
        ],
    ),
}

USAGE = {
    "preprocess": '''siga preprocess [OPTION] READS1 READS2 ...
Prepare READS1, READS2, ... data files for assembly

  -o, --out=FILE             write the reads to FILE (default: stdout)
      --pe-mode=INT          0 = unpaired (default); 1 = reads paired across
                             READS1/READS2, interleaved in the output;
                             2 = pairs interleaved within a single file
      --pe-orientation=STR   fr (default), rf, ff
      --with-index           barcode index file precedes each reads file
      --phred64              convert quality values from phred-64 to phred-33
  -q, --quality-trim=INT     BWA quality trim algorithm with threshold INT
  -f, --quality-filter=INT   discard reads with more than INT low-quality bases
  -m, --min-length=INT       discard sequences shorter than INT (default: 40)
      --hard-clip=INT        clip all reads to length INT
      --sample-rate=FLOAT    subsample reads/pairs with probability FLOAT
      --no-primer-check      disable the primer-sequence check''',
    "index": '''siga index [OPTION] ... READSFILE
Index the reads in READSFILE using a suffix array/BWT

  -a, --algorithm=STR        sais2 (device prefix-doubling, default) | host
  -t, --threads=NUM          worker threads (device path ignores this)
  -p, --prefix=PREFIX        output prefix (default: stem of READSFILE)
      --no-forward           skip the forward BWT
      --no-reverse           skip the reverse BWT''',
    "correct": '''siga correct [OPTION] ... READSFILE
Correct sequencing errors in the reads

  -p, --prefix=PREFIX        index prefix (default: stem of READSFILE)
  -k, --kmer-size=N          k-mer size (default: 31)
  -x, --kmer-threshold=N     attempt correction below this coverage (default: 3)
      --kmer-rounds=N        max correction rounds per read (default: 10)
  -o, --out=FILE             output file (default: PREFIX.ec.fa)
      --engine=batch|host|tpu correction engine (default: auto = the
                             vectorized batch corrector when the index
                             matches the input reads)''',
    "overlap": '''siga overlap [OPTION] ... READSFILE
Compute pairwise overlaps between all the sequences in READS

  -m, --min-overlap=LEN      minimum overlap length (default: 10)
  -p, --prefix=PREFIX        index prefix (default: stem of READSFILE)
  -t, --threads=NUM          hits output shards (default: 1)
  -x, --exhaustive           output all overlaps, including transitive edges
      --no-opposite-strand   treat all reads as forward strand
      --engine=host|tpu      stage-A engine (default: auto)
      --process-id=I         multi-host worker: compute only reads I mod N,
                             write hits shard I (index replicated per host)
      --num-processes=N      multi-host world size
      --merge-only           emit the ASQG from existing hits shards (-t N)''',
    "assemble": '''siga assemble [OPTION] ... ASQGFILE
Create contigs from the assembly graph ASQGFILE

  -p, --prefix=NAME          output prefix (NAME-contigs.fa, NAME-graph.asqg.gz)
  -m, --min-overlap=LEN      only load overlaps of at least LEN
      --max-edges=N          per-vertex edge cap (default: unlimited)
      --pe-mode=INT          0 (default) | 1 = treat reads as paired
      --with-index           treat as 10x linked-read data
      --max-distance=INT     paired-read link distance (default: 100)
      --insert-size=INT      insert size (default: learned)
      --insert-size-delta=INT insert size delta (default: learned)
  -x, --cut-terminal=N       trim rounds (default: 10)
  -n, --min-branch-length=LEN trim branches shorter than LEN (default: 150)
  -d, --max-overlap-delta=LEN maximum-overlap reduction delta (default: 0)
      --max-overlap-carefully reciprocal-maximality check before removal
  -l, --min-chimeric-length=LEN enable chimeric removal below LEN
  -M, --ai-model=FILE        JSON bagged-tree edge classifier''',
    "rmdup": '''siga rmdup [OPTION] ... READSFILE
Remove duplicated reads from the data set

  -p, --prefix=PREFIX        index prefix
  -t, --threads=N            worker threads''',
    "subgraph": '''siga subgraph [OPTION] ... ID ASQGFILE
Extract the subgraph around sequence with ID from an asqg file

  -o, --out=FILE             output (default: subgraph.asqg.gz)
  -m, --min-overlap=LEN      only load overlaps of at least LEN
      --size=N               neighborhood radius in hops (default: 5)''',
    "match": '''siga match [OPTION] ... READSFILE
Match reads in READSFILE against the index

  -p, --prefix=PREFIX        index prefix
  -l, --max-length=N         probe only N-long prefix/suffix of long reads
      --no-opposite-strand   do not count reverse-complement matches''',
    "preqc": '''siga preqc [OPTION] READSFILE
Perform pre-assembly quality checks (JSON report on stdout)

      --simple               only metrics that do not need the FM-index
      --sample-rate=FLOAT    read sampling rate (default: 0.05)
      --kmer=N               k for the genome-size estimate (default: 31)''',
    "gan": '''siga gan [OPTION] ... ASQGFILE
Emit labeled training rows for graph edges

  -p, --prefix=PREFIX        output prefix
      --ref=PREFIX           reference FM-index prefix for ground truth
  -m, --min-overlap=LEN      only load overlaps of at least LEN''',
}

DESCRIPTIONS = {
    "preprocess": "filter and quality-trim reads",
    "index": "build the BWT and FM-index for a set of reads",
    "correct": "correct sequencing errors in reads",
    "overlap": "compute overlaps between reads",
    "assemble": "generate contigs from an assembly graph",
    "subgraph": "extract a subgraph from a graph",
    "rmdup": "duplicate reads removal",
    "preqc": "preform pre-assembly quality checks",
    "match": "match a set of reads with ref",
    "gan": "emit ML training data for edge classification",
}


def parse_options(command: str, argv: List[str]) -> Tuple[dict, List[str]]:
    shortopts, longspec = OPTION_TABLES[command]
    longopts = [name + ("=" if has_arg else "") for name, has_arg, _s in longspec]
    short_to_long = {s: name for name, _h, s in longspec if s}
    pairs, args = getopt.gnu_getopt(argv, shortopts, longopts)
    opts: dict = {}
    for key, val in pairs:
        if key.startswith("--"):
            name = key[2:]
        else:
            name = short_to_long.get(key[1:], key[1:])
        has_arg = next((h for n, h, _s in longspec if n == name), False)
        if not has_arg:
            opts[name] = True
        elif name in opts:
            opts[name] = f"{opts[name]}:{val}"  # repeated flags concatenate
        else:
            opts[name] = val

    # merge --ini file options under CLI precedence
    if "ini" in opts:
        parser = configparser.ConfigParser()
        parser.read(opts["ini"])
        merged: dict = {}
        for section in parser.sections():
            for k, v in parser.items(section):
                merged[k] = v
        for k, v in parser.defaults().items():
            merged[k] = v
        merged.update(opts)
        opts = merged
    return opts, args


def help_text() -> str:
    lines = [
        "siga-tpu: a TPU-native string graph assembler",
        "",
        "Usage: siga <command> [<args>]",
        "",
        "The most commonly used siga commands are:",
    ]
    visible = [c for c in OPTION_TABLES if COMMAND_RANKS.get(c, 1000) < 1000]
    visible.sort(key=lambda c: (COMMAND_RANKS.get(c, 1000), c))
    width = max(len(c) for c in visible) + 2
    for c in visible:
        lines.append(f"   {c.ljust(width)}{DESCRIPTIONS[c]}")
    lines.append("")
    lines.append("See 'siga <command> -h' to read about a specific subcommand.")
    return "\n".join(lines)


MODULES = {
    "preprocess": "siga_tpu_torch.commands.preprocess",
    "index": "siga_tpu_torch.commands.index_cmd",
    "correct": "siga_tpu_torch.commands.correct_cmd",
    "overlap": "siga_tpu_torch.commands.overlap_cmd",
    "assemble": "siga_tpu_torch.commands.assemble_cmd",
    "rmdup": "siga_tpu_torch.commands.rmdup_cmd",
    "subgraph": "siga_tpu_torch.commands.subgraph_cmd",
    "match": "siga_tpu_torch.commands.match_cmd",
    "preqc": "siga_tpu_torch.commands.preqc_cmd",
    "gan": "siga_tpu_torch.commands.gan_cmd",
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
        print(help_text())
        print(f"\nPorted to PyTorch/CUDA: {', '.join(PORTED)}")
        return 0 if argv else 1
    command = argv[0]
    if command not in MODULES:
        print(help_text())
        return 1
    args = argv[1:]
    device = None
    if command in ON_DEVICE:
        args, device = _split_device(args)
    opts, args = parse_options(command, args)
    if device is not None:
        opts["device"] = device

    from .core import logconf

    logconf.configure(opts.get("log4cxx"))
    mod = importlib.import_module(MODULES[command])
    if opts.get("help"):
        print(USAGE[command])
        if command in ON_DEVICE:
            print(f"      --device=cuda|cpu      {DEVICE_HELP[command]} (default: cuda)")
        return 256
    # every command runs on the port's host build of the C++ runtime, built
    # here under a file lock before anything loads it
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
