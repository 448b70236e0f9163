"""K6's route (`index/sa.py`: seed keys, a one-byte first pass, the doubling
rounds over the tied positions alone, the BWT and permutation by a scan) on
the CPU, where each step runs its plain version: held to the JAX package's
device and numpy builders and to the all-torch route it replaced
(`suffix_array_plain`, `bwt_perm_plain`), and each step to the code it
replaces.  Suffix orders and permutations are integers: equality is exact."""
import json
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import sa_edge_reads
from siga_tpu.index import sa as jax_sa
from siga_tpu_torch.index import sa
from siga_tpu_torch.probes import kernel_ab, sa_parts
from test_torch_index import CASES

TEXTS = {**{f"case {k}": f for k, f in CASES.items()},
         **{f"edge {k}": (lambda r=r: r) for k, r in sa_edge_reads().items()}}


def _codes(label):
    return sa.concat_reads(TEXTS[label]())[0]


@pytest.mark.parametrize("label", sorted(TEXTS))
def test_route_matches_jax_numpy_and_plain(label):
    codes = _codes(label)
    got = sa.suffix_array_device(codes, "cpu").numpy()
    np.testing.assert_array_equal(got, jax_sa.suffix_array_numpy(codes))
    np.testing.assert_array_equal(got, jax_sa.suffix_array_jax(codes))
    np.testing.assert_array_equal(got, sa.suffix_array_plain(codes, "cpu").numpy())


@pytest.mark.parametrize("label", sorted(TEXTS))
def test_bwt_perm_matches_jax_and_plain(label):
    """Against `_sa_bwt_perm_v3` with one permutation entry a '$' of the text
    (an N is a '$' of the rank text: the JAX program takes as many '$' rows
    as it is told, the port all of them, as before)."""
    codes = _codes(label)
    bwt, perm = sa.bwt_perm_device(codes, "cpu")
    want_bwt, want_perm = sa.bwt_perm_plain(codes, "cpu")
    np.testing.assert_array_equal(bwt, want_bwt)
    np.testing.assert_array_equal(perm, want_perm)
    (jax_bwt, jax_perm), = jax_sa._device_index_build([codes], None, int((codes == 0).sum()))
    np.testing.assert_array_equal(bwt, jax_bwt)
    np.testing.assert_array_equal(perm, jax_perm)


def test_edge_texts_cover_the_route():
    """The edge texts reach 0, 1, 2 and 3 rounds, a tied group larger than
    a scan tile (2,048), sentpos at its cap, and texts of 1 and 2 codes."""
    plans = {k: sa.sort_plan(sa.concat_reads(r)[0]) for k, r in sa_edge_reads().items()}
    assert {p.rounds for p in plans.values()} == {0, 1, 2, 3}
    assert plans["one tied group of 5,480 (40 x 200 A)"].tied == 5480
    assert plans["63, 64 and 65 symbols"].tied > 0
    assert sa.concat_reads(sa_edge_reads()["one symbol"])[0].size == 2


@pytest.mark.parametrize("label", sorted(TEXTS))
def test_sort_plan_counts_what_the_steps_find(label):
    codes = _codes(label)
    plan = sa.sort_plan(codes)
    n = codes.size
    sentpos, _ka, _kb, upos = sa.seed_keys(torch.from_numpy(codes), n, plan.tied)
    assert plan.rounds == jax_sa._sa_rounds_v3(jax_sa._max_span(codes))
    assert plan.tied == int((sentpos == sa.GRAM3).sum()) == upos.numel()
    assert plan.reads == int((codes == 0).sum())
    assert torch.equal(upos.long(), torch.nonzero(sentpos == sa.GRAM3).flatten())


def test_sort_plan_needs_a_final_sentinel():
    with pytest.raises(ValueError, match="must end in"):
        sa.sort_plan(np.array([1, 2, 0, 3], dtype=np.uint8))


def _seed(codes, plan):
    """The route's seed on the CPU: (keys, order, rank, uslot)."""
    n = codes.size
    sentpos, key_a, key_b, upos = sa.seed_keys(torch.from_numpy(codes), n, plan.tied)
    idx = torch.sort(sentpos, stable=True).indices
    order, key = sa.gather_keys(None, idx, key_b)
    idx = torch.sort(key, stable=True).indices
    order, key = sa.gather_keys(order, idx, key_a)
    key_s, idx = torch.sort(key, stable=True)
    return (sentpos, key_a, key_b, upos), sa.seed_ranks(order, idx, key_s, key_b, sentpos,
                                                        plan.tied)


@pytest.mark.parametrize("label", sorted(TEXTS))
def test_one_byte_first_pass_equals_the_position_key(label):
    """A stable sort by sentpos alone orders as the old first pass, a sort
    by pack64(sentpos, position)."""
    codes = _codes(label)
    sentpos = sa.seed_keys(torch.from_numpy(codes), codes.size)[0]
    old = torch.sort(sa.pack64(sentpos.long(), torch.arange(codes.size)), stable=True).indices
    assert torch.equal(torch.sort(sentpos, stable=True).indices, old)


@pytest.mark.parametrize("label", sorted(TEXTS))
def test_seed_equals_the_three_packed_passes(label):
    """The seed order equals `_sort_by` over the old packed keys, and its
    group-head ranks order the positions as the old dense ranks do."""
    codes = _codes(label)
    plan = sa.sort_plan(codes)
    (sentpos, key_a, key_b, _upos), (order, rank, uslot) = _seed(codes, plan)
    sp = sentpos.long()
    old = sa._sort_by([sa.pack64(sp, torch.arange(codes.size)), key_b, key_a])
    assert torch.equal(order, old)
    s_sp = sp[old]
    boundary = ((key_a[old][1:] != key_a[old][:-1]) | (key_b[old][1:] != key_b[old][:-1])
                | (s_sp[1:] != s_sp[:-1]) | (s_sp[1:] != sa.GRAM3))
    dense = torch.empty(codes.size, dtype=torch.int64)
    dense[old] = sa._ranks(boundary)
    heads = rank[old].long()
    assert torch.equal(heads[1:] != heads[:-1], dense[old][1:] != dense[old][:-1])
    assert bool((heads <= torch.arange(codes.size)).all())
    assert torch.equal(uslot.long(), torch.nonzero(s_sp == sa.GRAM3).flatten())


@pytest.mark.parametrize("label", sorted(TEXTS))
def test_subset_doubling_equals_the_full_doubling(label):
    """Each round over the tied positions alone leaves the order a sort of
    every position by pack64(rank, rank ahead + 1) leaves (the old round),
    and before the last round the ranks that sort's runs give."""
    codes = _codes(label)
    plan = sa.sort_plan(codes)
    n = codes.size
    (_sp, _ka, _kb, upos), (order, rank, uslot) = _seed(codes, plan)
    for r in range(plan.rounds):
        h, last = sa.GRAM3 << r, r == plan.rounds - 1
        ahead = torch.zeros(n, dtype=torch.int64)
        ahead[: max(n - h, 0)] = rank[h:].long() + 1
        full_key, full = torch.sort(sa.pack64(rank.long(), ahead), stable=True)
        key_s, idx = torch.sort(sa.round_keys(upos, rank, h, n), stable=True)
        sa.round_scatter(idx, key_s, upos, uslot, order, None if last else rank)
        assert torch.equal(order, full), f"round {r}"
        if not last:
            first = torch.ones(n, dtype=torch.bool)
            first[1:] = full_key[1:] != full_key[:-1]
            want = torch.empty(n, dtype=torch.int64)
            want[full] = torch.cummax(torch.where(first, torch.arange(n), 0), 0).values
            assert torch.equal(rank.long(), want), f"round {r}"
    assert torch.equal(order, sa.suffix_array_plain(codes, "cpu"))


@pytest.mark.parametrize("label", sorted(TEXTS))
def test_bwt_perm_step_equals_the_mask_select(label):
    """The step's scan-compacted permutation (read ids by a binary search
    over the SA's sentinel rows) equals the old derivation: the sentinel
    count before each '$' row's suffix, selected by a boolean mask."""
    codes = _codes(label)
    c = torch.from_numpy(codes)
    sa_t = sa.suffix_array_plain(codes, "cpu")
    bwt, perm = sa.bwt_perm(sa_t, c, int((codes == 0).sum()))
    old_bwt = torch.where(sa_t == 0, 0, c[(sa_t - 1).clamp(min=0)])
    is_sent = c == 0
    rid = torch.cumsum(is_sent, 0) - is_sent.long()
    assert torch.equal(bwt, old_bwt.to(torch.uint8))
    assert torch.equal(perm, rid[sa_t[old_bwt == 0]])
    assert torch.equal(sa_t[: int(is_sent.sum())], torch.nonzero(is_sent).flatten())


def test_compactions_pad_with_zeros():
    """The seed's compactions sized past their count (as the route sizes
    them, n) hold the count's entries, then zeros; one too small raises."""
    codes = sa.concat_reads(sa_edge_reads()["rounds 1 (100 bp)"])[0]
    n, m = codes.size, sa.sort_plan(codes).tied
    upos = sa.seed_keys(torch.from_numpy(codes), n, n)[3]
    assert torch.equal(upos[:m], sa.seed_keys(torch.from_numpy(codes), n, m)[3])
    assert upos.numel() == n and not upos[m:].any()
    with pytest.raises(ValueError, match="do not fit"):
        sa.seed_keys(torch.from_numpy(codes), n, m - 1)


def test_route_records_each_step_once():
    """`index_arrays_device(..., record)` keeps the first call of each step
    (chip_smoke.py replays them against the plain versions); with two rounds
    the scatter shows in both its forms."""
    codes = sa.concat_reads(sa_edge_reads()["rounds 2 (37 and 200)"])[0]
    record = {}
    bwt, perm = sa.index_arrays_device(codes, "cpu", record)
    assert list(record) == ["sa_seed_keys", "sa_gather, key_b", "sa_gather, key_a",
                            "sa_seed_ranks", "sa_round_keys", "sa_round_scatter",
                            "sa_round_scatter, last round", "sa_bwt_perm"]
    assert {name for name, _args in record.values()} == set(sa.STEPS)
    name, args = record["sa_bwt_perm"]
    got = sa.STEPS[name][1](*args)
    assert torch.equal(got[0], bwt) and torch.equal(got[1], perm)


@pytest.mark.parametrize("step", ["gather", "round_keys", "bwt_perm"])
def test_steps_raise_off_cpu_and_cuda(step):
    """A wrapper runs its plain version only for a CPU tensor: on any other
    device but CUDA it raises."""
    meta = torch.zeros(4, dtype=torch.int64, device="meta")
    call = {
        "gather": lambda: sa.gather_keys(None, meta, meta),
        "round_keys": lambda: sa.round_keys(meta.to(torch.int32), meta.to(torch.int32), 64, 8),
        "bwt_perm": lambda: sa.bwt_perm(meta, meta.to(torch.uint8), 1),
    }[step]
    with pytest.raises(ValueError, match="unsupported device"):
        call()


def test_kernel_ab_sa_is_a_mode_of_its_own(capsys):
    with pytest.raises(SystemExit):
        kernel_ab.main(["--trees", "a,b", "--pipeline", "p", "--sa", "--plane"])
    assert "not allowed with argument" in capsys.readouterr().err


def _worker_line(tree, digest):
    run = {"tree": tree, "build_s": 1.0, "times": {"K6 reads.ec.fa (9 chars), "
                                                    "suffix_array_device wall median": 2.5},
           "digests": {"K6 reads.ec.fa (9 chars)": digest},
           "counts": {"K6 reads.ec.fa (9 chars)": {"device operations": 30,
                                                  "sort passes": [[1, 3], [8, 10]]}}}
    return "KERNEL_AB " + json.dumps(run)


def test_kernel_ab_sa_runs_workers_in_turn_and_prints_one_json_line(tmp_path, monkeypatch, capsys):
    """--sa starts one worker a --order entry with --sa, on its checkout, and
    prints the runs as one JSON line; outputs that differ raise."""
    calls = []

    def fake_run(cmd, cwd, env, **_kw):
        calls.append((cmd, cwd))
        return subprocess.CompletedProcess(cmd, 0, _worker_line(cwd, "d1") + "\n", "")

    monkeypatch.setattr(kernel_ab.subprocess, "run", fake_run)
    trees = [tmp_path / "old", tmp_path / "new"]
    for t in trees:
        t.mkdir()
    argv = ["--trees", f"{trees[0]},{trees[1]}", "--pipeline", str(tmp_path), "--sa"]
    assert kernel_ab.main(argv) == 0
    assert [cwd for _cmd, cwd in calls] == [str(trees[i]) for i in (0, 1, 1, 0)]
    assert all("--sa" in cmd and "--worker" in cmd for cmd, _cwd in calls)
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["outputs_equal"] and len(result["runs"]) == 4
    assert result["runs"][0]["counts"]["K6 reads.ec.fa (9 chars)"]["sort passes"] == [[1, 3], [8, 10]]
    assert not (tmp_path / "kernel_ab").exists()  # --sa writes no inputs

    digests = iter(["d1", "d2", "d1", "d1"])
    monkeypatch.setattr(kernel_ab.subprocess, "run", lambda cmd, cwd, env, **_kw: (
        subprocess.CompletedProcess(cmd, 0, _worker_line(cwd, next(digests)), "")))
    with pytest.raises(AssertionError, match="outputs differ"):
        kernel_ab.main(argv)


@pytest.mark.parametrize("name", sorted(sa_parts.CHANGES))
def test_sa_parts_changes_apply_to_the_source(name):
    """The probe's source changes find their anchors in
    `csrc/suffix_sort.cu` as it stands, once each; a changed source fails."""
    with open(sa_parts.SOURCE) as f:
        source = f.read()
    text = sa_parts.changed(source, name)
    assert text != source and text.count("rank[pos[j]]") == source.count("rank[pos[j]]") - (
        2 * ("slot_order" in name))
    with pytest.raises(RuntimeError, match="want one"):
        sa_parts.changed(source.replace(sa_parts.CHANGES[name][0][0], ""), name)
