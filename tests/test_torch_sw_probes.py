"""The CPU side of K5's card probes and of the second-card check:
`probes.kernel_ab --sw` takes its arguments as a mode of its own, draws its
synthetic pairs as chip_smoke.py's K5 check does and its edge pairs from
an ASQG; `probes.second_card` holds every wrapper on one device to another
(here CPU to CPU, the plain versions) and refuses a host without two cards;
`chip_smoke.py` names a kernel with several template arguments.
"""
import gzip
import os

import numpy as np
import pytest
import torch

from siga_tpu_torch.core import dna
from siga_tpu_torch.probes import kernel_ab, second_card

from chip_smoke import ptxas_summary


def test_kernel_ab_sw_is_a_mode_of_its_own(capsys):
    for other in ("--plane", "--probes", "--scan"):
        with pytest.raises(SystemExit):
            kernel_ab.main(["--trees", "a,b", "--pipeline", "p", "--sw", other])
        assert "not allowed with argument" in capsys.readouterr().err


def test_sw_synthetic_pairs_are_fixed_by_the_seed():
    """4,096 pairs of 150 x 400 symbols, the same for the same seed; about
    half of the refs hold the query with at most 8 substitutions."""
    qs, rs = kernel_ab.sw_synthetic_pairs()
    assert len(qs) == len(rs) == kernel_ab.SW_PAIRS
    assert {len(q) for q in qs} == {150} and {len(r) for r in rs} == {400}
    assert (qs, rs) == kernel_ab.sw_synthetic_pairs(kernel_ab.SW_SEED)
    near = sum(any(sum(a != b for a, b in zip(q, r[p : p + 150])) <= 8 for p in range(251))
               for q, r in zip(qs[:200], rs[:200]))
    assert 70 <= near <= 130


@pytest.fixture()
def pipeline(tmp_path):
    """A pipeline directory holding reads.ec.fa and an ASQG of its edges,
    one of them between opposite strands."""
    rng = np.random.default_rng(4)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 400))
    seqs = {f"read{i}": genome[20 * i : 20 * i + 100] for i in range(10)}
    seqs["read9"] = dna.reverse_complement(seqs["read9"])
    (tmp_path / "reads.ec.fa").write_text("".join(f">{k}\n{v}\n" for k, v in seqs.items()))
    lines = ["HT\tVN:i:1"] + [f"VT\t{k}\t{v}" for k, v in seqs.items()]
    lines += [f"ED\tread{i} read{i + 1} 20 99 100 0 79 100 0 0" for i in range(8)]
    lines.append("ED\tread8 read9 20 99 100 20 99 100 1 0")
    with gzip.open(tmp_path / "reads.ec.asqg.gz", "wt") as f:
        f.write("\n".join(lines) + "\n")
    return tmp_path, seqs


def test_sw_edge_pairs_take_the_overlap_and_the_second_read(pipeline):
    """A drawn edge pairs the overlap substring of its first read with its
    second read, reverse-complemented where the edge joins opposite
    strands; make_sw_inputs writes them once, a pair a line."""
    root, seqs = pipeline
    n_vt, n_ed, qs, rs = kernel_ab.sw_edge_pairs(
        str(root / "reads.ec.asqg.gz"), seqs, 100, np.random.default_rng(0))
    assert (n_vt, n_ed, len(qs)) == (10, 9, 9)
    for q, r in zip(qs, rs):
        first = next(v for v in seqs.values() if v[20:] == q)
        assert len(q) == 80 and first[20:] == q
        assert r[:80] == q  # the next read starts where the overlap does
    path = kernel_ab.make_sw_inputs(str(root))
    rows = [line.split("\t") for line in open(path).read().splitlines()]
    assert len(rows) == 9 and all(len(r) == 2 for r in rows)
    os.utime(path, (0, 0))
    assert kernel_ab.make_sw_inputs(str(root)) == path and os.path.getmtime(path) == 0


def test_sw_cases_run_the_plain_version_on_the_cpu(pipeline):
    """Both of kernel_ab --sw's cases as zero-padded rank codes: the
    synthetic 4,096 x 150 x 400 and the pipeline's edges; the wrapper runs
    them on the CPU."""
    from siga_tpu_torch.ops import sw

    root, _seqs = pipeline
    kernel_ab.make_sw_inputs(str(root))
    cases = kernel_ab.sw_cases(str(root), torch.device("cpu"))
    (syn, (sq, sr)), (edge, (eq, er)) = cases.items()
    assert syn.startswith("K5 synthetic") and (sq.shape, sr.shape) == ((4096, 150), (4096, 400))
    assert "reads.ec edges" in edge and (eq.shape, er.shape) == ((9, 80), (9, 100))
    best, qend, rend = sw.sw_wavefront(eq, er, *kernel_ab.SW_PARAMS)
    assert (best == 160).all() and (qend == 79).all() and (rend == 79).all()


def test_second_card_holds_every_wrapper_to_the_first_device():
    """Every kernel's wrapper (K1, K2, K3, K5, K7, G1-G4 and G3's two modes)
    on a second device equals the first; CPU against CPU here, the plain
    versions, with each output on its inputs' device."""
    got = second_card.compare("cpu", "cpu")
    kernels = {"K1 scan_pair", "K2 build_pair_plane", "K3 scan_single", "K5 sw_wavefront",
               "K7 count_kmers"}
    assert kernels <= set(got)
    probes = {label.split()[1] for label in got if label.startswith("G ")}
    assert probes == {"gather_rows", "take_along", "gather_chain", "scale2"}
    assert sum(label.startswith("G gather_chain") for label in got) == 2
    assert all(n >= 1 for n in got.values())


def test_second_card_needs_two_cards():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("this host has two cards")
    with pytest.raises(RuntimeError, match="needs two cards"):
        second_card.main([])


def test_ptxas_summary_names_every_template_argument():
    report = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116chain_sum_kernelILi8ELb1EEEvPKixxiiNS_8FloorModES2_S2_iiiPi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116chain_sum_kernelILi8ELb1EEEvPKixxiiNS_8FloorModES2_S2_iiiPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19sw_kernelILi32EEEvPKiS2_iiiNS_6ParamsEPiS4_S4_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19sw_kernelILi32EEEvPKiS2_iiiNS_6ParamsEPiS4_S4_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 234 registers, used 0 barriers, 1024 bytes smem
"""
    assert ptxas_summary(report) == [
        "chain_sum_kernel<8, 1>: Used 32 registers, used 0 barriers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "sw_kernel<32>: Used 234 registers, used 0 barriers, 1024 bytes smem; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    ]
