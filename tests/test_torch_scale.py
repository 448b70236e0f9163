"""The main path's and the error pipeline's sizes in `chip_smoke.py`: the
1 Mb and 4.6 Mb gates as BASELINE.md states them, the E. coli-size cell's
shapes, the pipeline's read set against `benchmark/ecoli_scale.py`'s, and a
kept pipeline resumed from a middle stage (`--from-stage`) against a whole
run, at 8 kb on the CPU."""
import gzip
import importlib.util
import os
import re
import shutil

import numpy as np
import pytest

import chip_smoke
from siga_tpu_torch.ops import search
from test_torch_overlap import port_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_NAMES = [name for name, _argv in chip_smoke.PIPE_STAGES]
RESUME_FROM = "assemble_pe"  # the sixth of the eleven stages


def baseline_facts(mb: float) -> dict:
    """The contig facts of BASELINE.md's table headed "| Config | MB Mb × 25×"."""
    with open(os.path.join(REPO, "BASELINE.md"), encoding="utf-8") as f:
        text = f.read()
    head = f"| Config | {mb:g} Mb × 25× (err 0.5%) |"
    assert text.count(head) == 1, head
    table = text[text.index(head):].split("\n\n", 1)[0]
    cells = dict(re.findall(r"^\| ([^|]+?) \| ([^|]+?) \|$", table, re.MULTILINE))

    def numbers(key):
        return [int(n.replace(",", "")) for n in re.findall(r"\d[\d,]*", cells[key])]

    reads = numbers("reads after correction")[0]
    contigs, matched, unmatched = numbers("contig_number / matched / unmatched")
    n50, n90, longest = numbers("N50 / N90 / MAX")
    return {"reads_corrected": reads, "contig_number": contigs, "matched_contig": matched,
            "unmatched_contig": unmatched, "N50": n50, "N90": n90, "MAX_contig": longest,
            "genome_covered": numbers("genome covered")[0]}


@pytest.mark.parametrize("mb, timeout", [(1.0, 600), (4.6, 2760)])
def test_pipeline_facts_are_baselines(mb, timeout):
    """The pipeline's size parameter gives BASELINE.md's facts at 1.0 and 4.6
    Mb, and a stage limit in proportion to the size."""
    assert chip_smoke.PIPE_FACTS[mb] == baseline_facts(mb)
    assert chip_smoke.stage_timeout(mb) == timeout
    assert sorted(chip_smoke.PIPE_FACTS) == [1.0, 4.6]


@pytest.mark.parametrize("genome, reads, chars, chunks, per_chunk", [
    (chip_smoke.GENOME, 166_667, 25_166_717, 11, 15_152),
    (chip_smoke.ECOLI_GENOME, 766_667, 115_766_717, 47, 16_313),
])
def test_error_free_cell_shapes(genome, reads, chars, chunks, per_chunk):
    """The error-free cells' reads, text and engine chunks: `simulate_reads`'
    read count at the genome size, a sentinel after each read, and
    `search.chunk_size`'s chunks."""
    n = -(-genome * chip_smoke.COVERAGE // chip_smoke.READ_LEN)
    assert n == reads
    assert n * (chip_smoke.READ_LEN + 1) == chars
    assert search.chunk_size(n) == per_chunk and -(-n // per_chunk) == chunks


def test_generated_reads_equal_ecoli_scale(tmp_path, monkeypatch):
    """At a 20 kb genome the pipeline's generator writes the files that
    `benchmark/ecoli_scale.py 0.02 25 0.005` writes before its first stage."""
    mine, theirs = tmp_path / "mine", tmp_path / "ecoli_scale"
    mine.mkdir()
    r1, r2 = chip_smoke.generate_reads(str(mine), 0.02)

    spec = importlib.util.spec_from_file_location(
        "ecoli_scale", os.path.join(REPO, "benchmark", "ecoli_scale.py"))
    ecoli_scale = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ecoli_scale)

    class FirstStage(Exception):
        pass

    def first_stage(args, **_kw):
        raise FirstStage(args)

    monkeypatch.setattr(ecoli_scale, "sh", first_stage)
    monkeypatch.setattr("sys.argv", ["ecoli_scale.py", "0.02", "25", "0.005", str(theirs)])
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FirstStage):
        ecoli_scale.main()
    names = sorted(os.listdir(theirs))
    assert names == sorted(os.listdir(mine)) == sorted(["ref.fa", r1, r2])
    for name in names:
        assert (mine / name).read_bytes() == (theirs / name).read_bytes(), name


def _content(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _files(d):
    return {n: os.stat(os.path.join(d, n)).st_mtime_ns for n in os.listdir(d)}


def test_resume_from_a_middle_stage(tmp_path, monkeypatch):
    """At 8 kb with `--device cpu`: a kept run that stopped before
    RESUME_FROM (the whole run's directory without what that stage and the
    later ones wrote), resumed with `from_stage`, runs only those stages and
    ends with the whole run's files, byte for byte."""
    monkeypatch.setattr(chip_smoke, "CHILD_ENV", port_env())
    run_cmd = chip_smoke.port_cmd
    written, ran = {}, []

    def port_cmd(argv, cwd, timeout=chip_smoke.STAGE_TIMEOUT):
        before = _files(cwd)
        out = run_cmd(argv, cwd, timeout)
        new = sorted(n for n, t in _files(cwd).items() if before.get(n) != t)
        written.setdefault(cwd, []).append(new)
        ran.append(argv[0])
        return out

    monkeypatch.setattr(chip_smoke, "port_cmd", port_cmd)
    whole, resumed = tmp_path / "whole", tmp_path / "resumed"
    whole.mkdir()
    chip_smoke.run_pipeline(str(whole), 0.008, "cpu")
    stages = written[str(whole)]
    assert len(stages) == len(STAGE_NAMES) and all(stages)
    later = [n for files in stages[STAGE_NAMES.index(RESUME_FROM):] for n in files]
    earlier = {n for files in stages[: STAGE_NAMES.index(RESUME_FROM)] for n in files}
    assert not earlier & set(later), "a later stage rewrote an earlier stage's file"
    # what the run held when it stopped: the read set and the earlier stages' files
    stopped = [n for n in os.listdir(whole) if n not in later and n != "unmatched.fa"]
    resumed.mkdir()
    for name in stopped:
        shutil.copy2(whole / name, resumed / name)
    del ran[:]
    chip_smoke.run_pipeline(str(resumed), 0.008, "cpu", from_stage=RESUME_FROM)
    want = [argv[0] for _name, argv in chip_smoke.PIPE_STAGES[STAGE_NAMES.index(RESUME_FROM):]]
    assert ran == want
    assert sorted(os.listdir(resumed)) == sorted(os.listdir(whole))
    for name in os.listdir(whole):
        assert _content(str(resumed / name)) == _content(str(whole / name)), name


@pytest.mark.parametrize("case", ["no kept directory", "unknown stage", "no read set"])
def test_resume_refusals(tmp_path, case):
    """`--from-stage` needs `--pipeline-mb` and `--keep-pipeline`; a resume
    names a stage of PIPE_STAGES and finds the read set in the directory."""
    if case == "no kept directory":
        with pytest.raises(SystemExit) as exc:
            chip_smoke.main(["--pipeline-mb", "4.6", "--from-stage", RESUME_FROM])
        assert exc.value.code == 2
    elif case == "unknown stage":
        with pytest.raises(ValueError, match="no stage 'assemble'"):
            chip_smoke.run_pipeline(str(tmp_path), 0.008, "cpu", from_stage="assemble")
    else:
        with pytest.raises(FileNotFoundError, match="no generated R1 and R2"):
            chip_smoke.run_pipeline(str(tmp_path), 0.008, "cpu", from_stage=RESUME_FROM)


@pytest.mark.parametrize("source", ["VmHWM", "VmRSS sampled"])
def test_stage_peak_rss_is_the_stage_own(tmp_path, monkeypatch, source):
    """A stage's peak RSS is its own process's: with 640 MB held here,
    `python -m siga_tpu_torch --version` reports far less, from the
    kernel's high-water mark or, where /proc has none (the card's host),
    from VmRSS sampled.  (Its ru_maxrss carries the parent's peak over the
    exec: on an H100 host four host stages of the 4.6 Mb pipeline each read
    the parent's 4,901,990,400 B that way.)"""
    monkeypatch.setattr(chip_smoke, "CHILD_ENV", port_env())
    if source == "VmRSS sampled":
        assert 'status("VmHWM:")' in chip_smoke.STAGE_CHILD
        monkeypatch.setattr(chip_smoke, "STAGE_CHILD",
                            chip_smoke.STAGE_CHILD.replace('status("VmHWM:")', "0"))
    held = np.ones(640 * 2**20 // 8)
    held += 1
    _wall, ran, _own, peaks = chip_smoke.port_cmd(["--version"], str(tmp_path))
    assert ran == {} and peaks["device"] == 0
    assert 0 < peaks["rss"] < 320 * 2**20 < held.nbytes, peaks
