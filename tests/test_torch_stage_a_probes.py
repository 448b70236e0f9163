"""The CPU side of K9's and G1's card probes: the source changes of
`probes.stage_a_parts` apply to `csrc/stage_a.cu` as it stands, its reads
are `chip_smoke.py`'s main path's, and `probes.kernel_ab --stage-a` is a mode
of its own whose cases name K9 and G1 at their shapes.  (The probes time the
kernels on the card; here only what they do before a card is needed, with
the wrappers' plain versions.)
"""
import os
import re

import numpy as np
import pytest
import torch

from siga_tpu_torch import cli as port_cli
from siga_tpu_torch.ops import fm_device
from siga_tpu_torch.probes import gather, kernel_ab, stage_a_parts

import chip_smoke
from test_pair_scan import _reads


@pytest.fixture(scope="module")
def source():
    with open(os.path.join(stage_a_parts.kernels.CSRC, "stage_a.cu")) as f:
        return f.read()


def test_the_source_is_the_pair_design_and_every_change_applies(source):
    assert stage_a_parts.design(source) == "pair"
    copies = stage_a_parts.changes(source)
    assert set(copies) == {"kernel", "no_stores", "chars_transposed", "fixed_row",
                           "no_stores+chars_transposed+fixed_row"}
    for name, pairs in copies.items():
        text = stage_a_parts.changed(source, pairs)
        assert (text == source) == (name == "kernel"), name
        assert text.count("{") == text.count("}"), name


def test_each_change_does_what_it_is_named_for(source):
    copies = stage_a_parts.changes(source)

    def text(name):
        return stage_a_parts.changed(source, copies[name])

    no_stores = text("no_stores")
    assert no_stores.count("if (a.L < 0) {") == 2 and no_stores.count("*va = ") == 2
    assert "    load_below(plane, q.row >> 30, q.tail, row);" in text("fixed_row")
    transposed = text("chars_transposed")
    assert "__ldg(chars + static_cast<size_t>(t + 1) * a.L)" in transposed
    assert "__ldg(chars + static_cast<size_t>(max_t) * a.L)" in transposed
    # the other designs' changes are their own: they do not all apply here
    for other in ("one-thread", "tiled", "pair-staged"):
        assert not all(all(source.count(old) == 1 for old, _new in pairs)
                       for pairs in stage_a_parts.DESIGNS[other].values()), other


def test_a_changed_source_fails_loudly(source):
    copies = stage_a_parts.changes(source)
    with pytest.raises(RuntimeError, match="want one"):
        stage_a_parts.changed(source.replace("    load_below(plane, q.row, q.tail, row);",
                                             "    load_below(plane, q.row,  q.tail, row);"),
                              copies["fixed_row"])


def test_the_history_designs_are_told_apart():
    """The designs kept in the history for the split's A/B are told apart by
    their sources; only the tiled one has the other row fetch."""
    assert stage_a_parts.design("struct WarpTile {};") == "pair-staged"
    assert stage_a_parts.design("const int lane = g >> 1, side = g & 1;") == "pair"
    assert stage_a_parts.design("struct WarpBuffers {};") == "tiled"
    assert stage_a_parts.design("int lane;") == "one-thread"
    assert [d for d, own in stage_a_parts.DESIGNS.items() if "other_fetch" in own] == ["tiled"]


def test_probe_reads_are_the_main_paths():
    want = chip_smoke.simulate_reads(np.random.default_rng(chip_smoke.SEED), 3000)
    assert stage_a_parts.simulated_reads(3000, chip_smoke.SEED) == want
    assert (stage_a_parts.SEED, stage_a_parts.GENOME, stage_a_parts.COVERAGE,
            stage_a_parts.READ_LEN) == (chip_smoke.SEED, chip_smoke.GENOME, chip_smoke.COVERAGE,
                                        chip_smoke.READ_LEN)
    assert stage_a_parts.LANES == chip_smoke.STAGE_A_LANES
    assert stage_a_parts.MIN_OVERLAP == chip_smoke.MIN_OVERLAP


def test_kernel_ab_stage_a_is_a_mode_of_its_own(capsys):
    for other in ("--scan", "--probes"):
        with pytest.raises(SystemExit):
            kernel_ab.main(["--trees", "a,b", "--pipeline", "p", "--stage-a", other])
        assert "not allowed with argument" in capsys.readouterr().err


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """A pipeline directory as kernel_ab --stage-a reads it, at a tiny size:
    reads.ec.fa and its index (`index --device cpu`)."""
    root = tmp_path_factory.mktemp("pipeline")
    reads = _reads(150, 120, 3)
    (root / "reads.ec.fa").write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(reads)))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        assert port_cli.main(["index", "--device", "cpu", "-p", "reads.ec", "reads.ec.fa"]) == 0
    finally:
        os.chdir(cwd)
    return str(root)


def test_stage_a_cases_name_k9_and_g1_at_their_shapes(pipeline):
    """K9 on the reads' lanes and at the dry run's tiny problem, G1 at each of
    its Pallas probes' shapes and on the pair plane; on the CPU the plain
    versions run: K9 equals `scan_stage_a_plain`, G1 its library call."""
    kernel_ab.make_stage_a_inputs(pipeline)
    lanes = kernel_ab._lines(os.path.join(pipeline, "kernel_ab", "stage_a_reads.txt"))
    assert len(lanes) == 154  # fewer reads than STAGE_A_LANES: all of them
    calls = kernel_ab.stage_a_calls(pipeline, torch.device("cpu"))
    g1 = [tpu for tpu, _w, name, _a in gather.probe_cases(np.random.default_rng(0))
          if name == "gather_rows"]
    assert {label: name for label, (name, _fn) in calls.items()} == {
        "K9 reads.ec.fa 154 lanes x 119 steps": "scan_stage_a",
        "K9 dryrun.entry 8 lanes x 23 steps": "scan_stage_a",
        **{f"G1 as {tpu}": "gather_rows" for tpu in g1},
        "G1 on the pair plane": "gather_rows",
    }
    for label, (name, fn) in calls.items():
        got = fn()
        if label.startswith("K9 reads"):
            want = fm_device.scan_stage_a_plain(*fn.args)
            assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True)), label
            assert int(got[1].sum()) > 0  # the reads' lanes emit probes
        elif name == "scan_stage_a":
            assert tuple(got[0].shape) == (23, 8, 3), label
        else:
            assert torch.equal(got, kernel_ab.library_call(name, fn.args)()), label


def test_step_instructions_count_the_longest_innermost_loop():
    """The probe's count of a step: the longest loop that holds no other,
    each opcode by the unit that runs it."""
    sass = "\n".join(f"        /*{a:04x}*/                   {op} ;" for a, op in [
        (0x10, "MOV R1, R2"), (0x20, "LOP3.LUT R1, R2, R3, RZ, 0xc0, !PT"), (0x30, "POPC R1, R1"),
        (0x40, "IMAD.MOV.U32 R1, RZ, RZ, R2"), (0x50, "@P0 BRA 0x20"), (0x60, "LDG.E R1, [R2]"),
        (0x70, "SHFL.BFLY PT, R1, R1, 0x1, 0x1f"), (0x80, "ISETP.GE.AND P0, PT, R1, R2, PT"),
        (0x90, "BRA 0x10"), (0xa0, "EXIT")])
    assert stage_a_parts.step_instructions(sass) == {
        "loop": 4, "alu": 1, "fma": 1, "popc": 1, "memory": 0, "other": 1}
