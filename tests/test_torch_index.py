"""The port's device suffix sort (`index -a sais2`) against the JAX package's
device and numpy builders, the golden index files, and the host seed-sort.
Suffix orders and file bytes are integers: equality is exact."""
import os

import numpy as np
import pytest
import torch

from siga_tpu.index import sa as jax_sa
from siga_tpu_torch import cli
from siga_tpu_torch.index import sa as torch_sa

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN_SEQS = ["ACGTACGTAC", "CGTACGTACC", "TTACGGACGT", "ACGTACGTAC", "GGGTTTACAC"]


def _random_reads(seed, n, lengths):
    rng = np.random.default_rng(seed)
    return [
        "".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.choice(lengths))))
        for _ in range(n)
    ]


def _prefix_pair():
    base = _random_reads(5, 1, [90])[0]
    return [base, base[:40], base + "ACGT"]


CASES = {
    "100bp": lambda: _random_reads(1, 60, [100]),  # one round
    "mixed37_200bp": lambda: _random_reads(2, 40, [37, 200]),  # two rounds
    "identical": lambda: ["ACGTTGCAAC" * 9] * 6,
    "prefix_of_another": _prefix_pair,
    "all_A": lambda: ["A" * 70, "A" * 70, "A" * 33],
    "single_read": lambda: _random_reads(3, 1, [150]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_suffix_array_device_matches_jax_and_numpy(case):
    codes, _starts, _lens = jax_sa.concat_reads(CASES[case]())
    got = torch_sa.suffix_array_device(codes, "cpu").numpy()
    np.testing.assert_array_equal(got, jax_sa.suffix_array_numpy(codes))
    np.testing.assert_array_equal(got, jax_sa.suffix_array_jax(codes))


def test_rounds_of_the_cases():
    """The cases cover the seed alone, one and two doubling rounds."""
    rounds = {
        case: torch_sa._sa_rounds_v3(torch_sa._max_span(jax_sa.concat_reads(f())[0]))
        for case, f in CASES.items()
    }
    assert rounds["100bp"] == 1 and rounds["mixed37_200bp"] == 2
    assert torch_sa._sa_rounds_v3(torch_sa._max_span(jax_sa.concat_reads(["ACG"])[0])) == 0


def test_bwt_perm_matches_jax_device_build():
    seqs = _random_reads(4, 50, [73, 100, 111])
    rev = [s[::-1] for s in seqs]
    codes, starts, _ = jax_sa.concat_reads(seqs)
    rcodes, _, _ = jax_sa.concat_reads(rev)
    want = jax_sa._device_index_build([codes, rcodes], starts, len(seqs))
    for text, (w_bwt, w_perm) in zip((codes, rcodes), want):
        bwt, perm = torch_sa.bwt_perm_device(text, "cpu")
        np.testing.assert_array_equal(bwt, w_bwt)
        np.testing.assert_array_equal(perm, w_perm)


def test_index_cpu_writes_golden(tmp_path):
    fa = tmp_path / "fixed.fa"
    fa.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(GOLDEN_SEQS)))
    assert cli.main(["index", "--device", "cpu", "-p", str(tmp_path / "fixed"), str(fa)]) == 0
    for name in ("fixed.sai", "fixed.bwt", "fixed.rsai", "fixed.rbwt"):
        with open(tmp_path / name, "rb") as a, open(os.path.join(GOLDEN, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("direction", ["--no-reverse", "--no-forward", None])
def test_index_sais2_equals_host(tmp_path, direction):
    fa = tmp_path / "reads.fa"
    fa.write_text(
        "".join(f">r{i}\n{s}\n" for i, s in enumerate(_random_reads(6, 80, [60, 101, 130])))
    )
    flags = [direction] if direction else []
    for algo, prefix in (("sais2", "dev"), ("host", "host")):
        argv = ["index", "--device", "cpu", "-a", algo, "-p", str(tmp_path / prefix), *flags]
        assert cli.main(argv + [str(fa)]) == 0
    exts = {"--no-reverse": (".sai", ".bwt"), "--no-forward": (".rsai", ".rbwt")}.get(
        direction, (".sai", ".bwt", ".rsai", ".rbwt")
    )
    for ext in (".sai", ".bwt", ".rsai", ".rbwt"):
        if ext not in exts:
            assert not (tmp_path / f"dev{ext}").exists(), ext
            continue
        assert (tmp_path / f"dev{ext}").read_bytes() == (tmp_path / f"host{ext}").read_bytes(), ext


def test_index_rejects_unknown_algorithm(tmp_path, capsys):
    fa = tmp_path / "r.fa"
    fa.write_text(">a\nACGT\n")
    assert cli.main(["index", "--device", "cpu", "-a", "bwtsw", "-p", str(tmp_path / "r"), str(fa)]) == 1
    assert "unknown algorithm" in capsys.readouterr().err


def test_pack64_orders_like_the_tuple():
    """Packed keys sort as (hi, lo) tuples, with words whose top bit is set
    and positions around 2**25 (where the JAX package's 7+25-bit tail key
    would overflow)."""
    rng = np.random.default_rng(9)
    n = 4000
    hi = rng.choice(
        np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1, 0x9E3779B9], dtype=np.int64), n
    )
    lo = np.concatenate([
        rng.integers(2**25 - 50, 2**25 + 50, n // 2),
        rng.choice(np.array([0, 2**31, 2**32 - 1, 2**31 - 1], dtype=np.int64), n - n // 2),
    ])
    packed = torch_sa.pack64(torch.from_numpy(hi), torch.from_numpy(lo))
    got = torch.sort(packed, stable=True).indices.numpy()
    np.testing.assert_array_equal(got, np.lexsort((lo, hi)))


def test_multikey_sort_equals_lexsort():
    """The seed's three stable passes over packed keys order suffixes as a
    lexsort over (k0, k1, k2, k3, sentpos, idx)."""
    rng = np.random.default_rng(10)
    n = 3000
    words = [rng.choice(np.array([0, 5, 2**31, 2**32 - 1], dtype=np.int64), n) for _ in range(4)]
    sentpos = rng.integers(1, 65, n)
    idx = np.arange(2**25 - n // 2, 2**25 + n - n // 2, dtype=np.int64)
    t = [torch.from_numpy(x) for x in (*words, sentpos, idx)]
    keys = [torch_sa.pack64(t[4], t[5]), torch_sa.pack64(t[2], t[3]), torch_sa.pack64(t[0], t[1])]
    got = torch_sa._sort_by(keys).numpy()
    want = np.lexsort((idx, sentpos, words[3], words[2], words[1], words[0]))
    np.testing.assert_array_equal(got, want)
