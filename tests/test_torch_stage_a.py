"""The stage-A scan with '$'-probes (K9's plain version, `fm_device.
scan_stage_a` on CPU tensors) against the JAX package's `_scan_stage_a`.

Same inputs through `siga_tpu.ops.fm_device._scan_stage_a` (XLA on the CPU)
and the port's `scan_stage_a`: the single-step plane is JAX's own, adopted
by the port through `DeviceFM.from_jax_state`; the lanes are the cases of
`chip_smoke.stage_a_edge_cases`, which `chip_smoke.py` also holds the CUDA
kernel `csrc/stage_a.cu` to on the card.  Every compared value is an
integer or a flag: equality is exact, in every slot, valid or not.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
from siga_tpu.index import sa as jax_sa
from siga_tpu.index.fm import FMIndex
from siga_tpu.ops import fm_device as jfm
from siga_tpu_torch import dryrun, kernels
from siga_tpu_torch.ops import fm_device as tfm

from chip_smoke import GOLDEN_READS, stage_a_args, stage_a_edge_cases, stage_a_index_reads
from test_torch_index import GOLDEN_SEQS

CASES = {case[0]: case for case in stage_a_edge_cases()}
NAMES = ("emitted", "valid", "final", "lext")


@pytest.fixture(scope="module")
def indexes():
    """{index label: (JAX DeviceFMs, port DeviceFMs adopting JAX's planes)},
    built lazily."""
    reads_of = stage_a_index_reads()
    cache = {}

    def get(label):
        if label not in cache:
            reads = reads_of[label]
            fwd, _p, rev, _rp, ns = jax_sa.build_index_arrays_pair(reads, use_device=False)
            jax_fms = [jfm.DeviceFM(FMIndex(codes, ns)) for codes in (fwd, rev)]
            port_fms = []
            for jd in jax_fms:
                plane, K = jd.pair_plane_device()
                port_fms.append(tfm.DeviceFM.from_jax_state(
                    np.asarray(plane), np.asarray(K), jd._host_pred, jd.length, jd.nblocks,
                    "cpu", occ_plane=np.asarray(jd.occ_plane)))
            cache[label] = jax_fms, port_fms
        return cache[label]

    return get


def _jax(args):
    max_t, mo, plane, pred, length, chars, lens, lane_tab = args
    out = jfm._scan_stage_a(
        max_t, mo, jnp.asarray(plane.numpy()), jnp.asarray(pred.numpy()), jnp.int32(length),
        jnp.asarray(chars.numpy()), jnp.asarray(lens.numpy()),
        None if lane_tab is None else jnp.asarray(lane_tab.numpy()),
    )
    return [np.asarray(x) for x in out]


def _assert_equal(got, want, label):
    for name, g, w in zip(NAMES, got, want, strict=True):
        assert g.dtype == (torch.bool if name == "valid" else torch.int32), name
        assert tuple(g.shape) == w.shape, (label, name)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{label}: {name}")


@pytest.mark.parametrize("label", list(CASES))
def test_plain_matches_jax(indexes, label):
    """Every slot of the four outputs equals JAX's, on every edge case."""
    case = CASES[label]
    jax_fms, port_fms = indexes(case[1])
    args = stage_a_args(case, port_fms, "cpu")
    if case[3] == "stacked":
        stacked = np.concatenate([np.asarray(jd.occ_plane) for jd in jax_fms])
        np.testing.assert_array_equal(args[2].numpy(), stacked)
    _assert_equal(tfm.scan_stage_a(*args), _jax(args), label)


def test_cases_cover_the_edges(indexes):
    """The cases hold what they are named for: blocks emitted (valid probes)
    on the genome reads, lanes of 1 and 2 symbols, garbage past l - 2 that
    the scan never reads (the outputs equal those with zeros there), a
    rank 0 in live steps, L of 1 and 33, max_t 0, and a full interval in the
    stacked plane's last row."""
    assert GOLDEN_READS == GOLDEN_SEQS
    assert stage_a_index_reads()["tiny 16 reads"] == __graft_entry__._tiny_problem(16)[0]
    _jax_fms, port_fms = indexes("64 reads of 100 bp")
    emitted, valid, final, lext = tfm.scan_stage_a(
        *stage_a_args(CASES["64 reads of 100 bp, stacked"], port_fms, "cpu"))
    assert int(valid.sum()) > 0 and emitted.shape == (99, 128, 3)
    _jax_fms, port_fms = indexes("40 reads of 1-60 bp")
    garbage = CASES["garbage past l - 2, lanes of 1 and 2 symbols"]
    g_args = stage_a_args(garbage, port_fms, "cpu")
    lens = g_args[6]
    assert {1, 2} <= set(lens.tolist())
    clean = stage_a_args((*garbage[:6], False), port_fms, "cpu")
    assert not torch.equal(g_args[5], clean[5])
    for a, b in zip(tfm.scan_stage_a(*g_args), tfm.scan_stage_a(*clean)):
        assert torch.equal(a, b)
    n_args = stage_a_args(CASES["an N in the live steps"], port_fms, "cpu")
    live = torch.arange(n_args[0])[None, :] < (n_args[6] - 1)[:, None]
    assert bool(((n_args[5][:, :-1] == 0) & live).any())
    assert stage_a_args(CASES["L = 1"], port_fms, "cpu")[5].shape[0] == 1
    assert stage_a_args(CASES["L = 33"], port_fms, "cpu")[5].shape[0] == 33
    emitted, valid, final, lext = tfm.scan_stage_a(
        *stage_a_args(CASES["max_t = 0"], port_fms, "cpu"))
    assert emitted.shape == (0, 80, 3) and valid.shape == (0, 80) and final.shape == (80, 8)
    stacked = stage_a_args(CASES["40 reads of 1-60 bp, stacked"], port_fms, "cpu")
    rows = stacked[2].shape[0]
    assert rows == 2 * port_fms[0].nblocks
    _e, _v, final, _x = tfm.scan_stage_a(*stacked)
    fhi_rows = (final[:, 1] + 1) // tfm.SAMPLE + stacked[7]
    assert int(fhi_rows.max()) == rows - 1


def test_entry_matches_jax():
    """`dryrun.entry` (the plain version on the CPU) gives what JAX's
    `__graft_entry__.entry` gives, from the same reads and chars."""
    fn, args = dryrun.entry("cpu")
    jfn, jargs = __graft_entry__.entry()
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = fn(*args)
    want = [np.asarray(x) for x in jfn(*jargs)]
    _assert_equal(got, want, "entry")


def test_stage_a_chars_are_the_jax_entrys():
    """`dryrun.stage_a_chars` builds the chars and lens as
    `__graft_entry__.py` does, for reads of several lengths."""
    from siga_tpu.core import dna

    seqs = stage_a_index_reads()["40 reads of 1-60 bp"]
    chars, lens = dryrun.stage_a_chars(seqs)
    max_t = int(max(map(len, seqs))) - 1
    want = np.zeros((len(seqs), max_t + 1), dtype=np.int32)
    for i, s in enumerate(seqs):
        ranks = dna.encode(s).astype(np.int32)
        for t in range(len(s) - 1):
            want[i, t] = ranks[len(s) - 2 - t]
        want[i, max_t] = ranks[len(s) - 1]
    np.testing.assert_array_equal(chars, want)
    np.testing.assert_array_equal(lens, [len(s) for s in seqs])


def test_plane_of_other_width_raises(indexes):
    """Only the 16-column single-step plane (block 128) is taken: a plane of
    other columns raises on every device, as do a chars width that is not
    max_t + 1 and an unsupported device."""
    _jax_fms, port_fms = indexes("golden 5 reads")
    args = list(stage_a_args(CASES["golden 5 reads, one index"], port_fms, "cpu"))
    for cols in (8, 28):
        wide = list(args)
        wide[2] = torch.zeros((args[2].shape[0], cols), dtype=torch.int32)
        with pytest.raises(ValueError, match="no other block is ported"):
            tfm.scan_stage_a(*wide)
        with pytest.raises(ValueError, match="no other block is ported"):
            tfm.scan_stage_a_plain(*wide)
    short = list(args)
    short[0] = args[0] + 1
    with pytest.raises(ValueError, match="max_t"):
        tfm.scan_stage_a(*short)
    meta = [x.to("meta") if isinstance(x, torch.Tensor) else x for x in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.scan_stage_a(*meta)


def test_cpu_route_is_the_plain_version(indexes, monkeypatch):
    """On CPU tensors the wrapper returns the plain version's outputs, counts
    no launch and never loads the kernels."""
    _jax_fms, port_fms = indexes("tiny 8 reads")
    args = stage_a_args(CASES["tiny 8 reads, stacked"], port_fms, "cpu")

    def no_lib():
        raise AssertionError("the CPU route loaded the kernels")

    monkeypatch.setattr(kernels, "lib", no_lib)
    before = dict(kernels.launches)
    got = tfm.scan_stage_a(*args)
    assert kernels.launches == before
    for a, b in zip(got, tfm.scan_stage_a_plain(*args)):
        assert torch.equal(a, b)
