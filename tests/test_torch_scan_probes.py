"""The CPU side of K3's card probes: `probes.kernel_ab --scan` takes its
arguments as a mode of its own and its cases name both kernels at both of
the pipeline's shapes; `kernel_ab.single_scan_args` builds a scan call's
arguments; `chip_smoke.py` names each kernel of a `-Xptxas -v` report.
(The probes time the kernels on the card; here only what they do before a
card is needed, with the wrappers' plain versions.)
"""
import os

import pytest
import torch

from siga_tpu_torch import cli as port_cli
from siga_tpu_torch.probes import kernel_ab

from chip_smoke import ptxas_summary
from test_pair_scan import _reads


def test_kernel_ab_scan_is_a_mode_of_its_own(capsys):
    for other in ("--plane", "--probes"):
        with pytest.raises(SystemExit):
            kernel_ab.main(["--trees", "a,b", "--pipeline", "p", "--scan", other])
        assert "not allowed with argument" in capsys.readouterr().err


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """A pipeline directory as kernel_ab reads it, at a tiny size: both
    cases' indexes (`index --device cpu`) and their inputs under kernel_ab/
    (the contigs' chunk with reads of mixed lengths)."""
    root = tmp_path_factory.mktemp("pipeline")
    reads = _reads(150, 120, 3)
    contigs = [r + s[:20] for r, s in zip(_reads(30, 90, 5), _reads(30, 40, 6))]
    contigs += [c[: 30 + 3 * k] for k, c in enumerate(_reads(12, 110, 8))]
    os.makedirs(root / "kernel_ab")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for (prefix, _mo), seqs in zip(kernel_ab.K1_CASES.values(), (reads, contigs)):
            (root / f"{prefix}.fa").write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
            assert port_cli.main(["index", "--device", "cpu", "-p", prefix, f"{prefix}.fa"]) == 0
            (root / "kernel_ab" / f"{prefix}.txt").write_text("\n".join(seqs) + "\n")
    finally:
        os.chdir(cwd)
    return str(root)


def test_scan_cases_name_both_kernels_at_both_shapes(pipeline):
    """K3 and the sharded K3 at every D of SCAN_SHARDS, at the reads.ec.fa
    chunk and at the contigs, each through its wrapper; on the CPU the plain
    versions run, and a case's calls agree output for output."""
    calls = kernel_ab.scan_calls(pipeline, torch.device("cpu"))
    shapes = [name.split(" ", 1)[1] for name in kernel_ab.K1_CASES]
    assert shapes == ["reads.ec.fa chunk", "contigs"]
    want = {}
    for shape in shapes:
        want[f"K3 {shape}"] = "scan_single"
        for d in kernel_ab.SCAN_SHARDS:
            want[f"sharded K3 D={d} {shape}"] = "scan_single_sharded"
    assert {label: name for label, (name, _fn) in calls.items()} == want
    assert kernel_ab.SCAN_SHARDS == (2, 4) and kernel_ab.SCAN_REPS >= 5
    for shape in shapes:
        outs = [fn() for label, (_name, fn) in calls.items() if label.endswith(shape)]
        assert len(outs) == 1 + len(kernel_ab.SCAN_SHARDS)
        assert int(outs[0][0][0]) > 0  # the case emits blocks
        for out in outs[1:]:
            assert all(torch.equal(x, y) for x, y in zip(out, outs[0], strict=True))


def test_single_scan_args_packs_one_call(pipeline):
    """The whole plane and its row shards come with the same arguments
    after them: the reads packed to the 16-symbol bucket, lim_t the longest
    read's last step, -m and the groups as given."""
    from siga_tpu_torch.ops import fm_device

    prefix, mo = kernel_ab.K1_CASES["K1 contigs"]
    reads = kernel_ab._lines(os.path.join(pipeline, "kernel_ab", prefix + ".txt"))
    fms = [fm_device.DeviceFM(fm_device.FMIndex.load(os.path.join(pipeline, prefix + ext)), "cpu")
           for ext in (".bwt", ".rbwt")]
    groups = ((fm_device.GROUP_ID,), (fm_device.GROUP_REV,))
    plane, tail = kernel_ab.single_scan_args(fms, groups, reads, len(reads), mo, "cpu")
    shards, sharded_tail = kernel_ab.single_scan_args(fms, groups, reads, len(reads), mo, "cpu",
                                                      devices=["cpu"] * 3)
    assert len(shards) == 3 and torch.equal(torch.cat(shards), plane)
    longest = max(map(len, reads))
    bucket = -(-longest // 16) * 16
    assert tail[3].shape == (len(reads), bucket // 16)
    assert list(tail[4]) == [len(r) for r in reads]
    assert tail[5:] == (min(bucket - 1, longest - 1), mo, *groups)
    for x, y in zip(tail, sharded_tail, strict=True):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


def test_ptxas_summary_names_each_kernel():
    report = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__55ee0345_14_scan_single_cu_27524e7618scan_single_kernelENS_10SingleArgsEiiiPiS1_PjS2_P4int4' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__55ee0345_14_scan_single_cu_27524e7618scan_single_kernelENS_10SingleArgsEiiiPiS1_PjS2_P4int4
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_16kernelILi4EEEvPi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_16kernelILi4EEEvPi
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 128 bytes smem
ptxas info    : Compiling entry function 'plain_entry' for 'sm_90a'
ptxas info    : Function properties for plain_entry
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 8 registers, used 0 barriers
"""
    assert ptxas_summary(report) == [
        "scan_single_kernel: Used 122 registers, used 0 barriers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "kernel<4>: Used 255 registers, used 1 barriers, 128 bytes smem; "
        "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "plain_entry: Used 8 registers, used 0 barriers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    ]
