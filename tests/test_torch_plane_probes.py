"""The CPU side of K2's card probes: the source changes of
`probes.plane_phases` apply to `csrc/pair_plane.cu` as it stands, and
`probes.kernel_ab` takes `--plane` as a mode of its own.  (The probes time
the kernel on the card; here only what they do before a card is needed.)
"""
import re

import pytest

from siga_tpu_torch.probes import kernel_ab, plane_phases


@pytest.fixture(scope="module")
def source():
    with open(plane_phases.SOURCE) as f:
        return f.read()


def test_phase_marks_open_every_numbered_phase_and_close_the_tile(source):
    text = plane_phases.phases(source)
    marks = [int(k) for k in re.findall(r"probe_mark\(tile, (\d+)\);", text)]
    assert marks == list(range(plane_phases.PHASES + 1))
    for k in range(1, plane_phases.PHASES + 1):  # each mark just before its phase
        assert f"probe_mark(tile, {k - 1});\n  // PHASE {k}: " in text
    assert text.count("__syncthreads();") == source.count("__syncthreads();") + 1
    assert text.rstrip().endswith("}") and "probe_set_marks" in text


def test_no_wait_only_skips_the_look_back(source):
    text = plane_phases.no_wait(source)
    body = re.search(r"__device__ uint4 look_back\(.*?\n}\n", text, re.S).group(0)
    assert "  return base;\n  for (int first" in body
    assert len(text) == len(source) - len("if (tile == 0) ")


def test_a_changed_source_fails_loudly(source):
    with pytest.raises(RuntimeError, match="want one"):
        plane_phases.no_wait(source.replace("  if (tile == 0) return base;\n", ""))
    with pytest.raises(RuntimeError, match="want one"):
        plane_phases.phases(source.replace("  // PHASE 4: ", "  // PHASE four: "))


def test_kernel_ab_plane_is_a_mode_of_its_own(capsys):
    with pytest.raises(SystemExit):
        kernel_ab.main(["--trees", "a,b", "--pipeline", "p", "--plane", "--probes"])
    assert "not allowed with argument" in capsys.readouterr().err
