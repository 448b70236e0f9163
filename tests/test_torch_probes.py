"""The gather probes' plain PyTorch versions against the JAX functions that
the Pallas probe kernels' bodies compute, on the CPU with jax.numpy, at the
probes' shapes cut small.  Integers: equality is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siga_tpu_torch.probes import gather

SCALE = 16


def _k_scan(table, init, c, steps, _mode):
    nb = table.shape[1]

    def body(t, state):
        idx = jnp.broadcast_to(((state + t) % nb)[None, :], table.shape[:1] + state.shape)
        g = jnp.take_along_axis(table, idx, axis=1)
        return (state + g.sum(axis=0) + c[t % c.shape[0]]) % nb

    return jax.lax.fori_loop(0, steps, body, init)


def _k_d(table, init, _c, steps, _mode):
    n = table.shape[1]

    def body(s, idx):
        return (idx + jnp.take_along_axis(table, idx, axis=1) + s) % n

    return jax.lax.fori_loop(0, steps, body, init)


def _k5(plane, idx):
    """Per-row copies in a loop, as the DMA kernel makes them."""

    def body(q, out):
        row = jax.lax.dynamic_slice(plane, (idx[q], 0), (1, plane.shape[1]))
        return jax.lax.dynamic_update_slice(out, row, (q, 0))

    return jax.lax.fori_loop(0, idx.shape[0], body, jnp.zeros((idx.shape[0], plane.shape[1]), jnp.int32))


def _taa_rows(plane, idx):
    ids = jnp.broadcast_to(idx.reshape(-1, 1), (idx.shape[0], plane.shape[1]))
    return jnp.take_along_axis(plane, ids, axis=0)


JAX = {
    "main.g kernel k": lambda x: x * 2,
    "k_lane": lambda t, i, _ax: jnp.take_along_axis(t, jnp.broadcast_to(i, t.shape), axis=1),
    "k_sub": _taa_rows,
    "k_scan": _k_scan,
    "k_a": lambda t, i, _ax: jnp.take_along_axis(t, i, axis=1),
    "k_b": lambda t, i, _ax: jnp.take_along_axis(t, i, axis=0),
    "k_c": lambda t, i, _ax: jnp.take_along_axis(t, i, axis=1),
    "k_d": _k_d,
    "k1": lambda p, i: jnp.take(p, i, axis=0),
    "k2": lambda pT, i, _ax: jnp.take(pT, i[0], axis=1),
    "k3": _taa_rows,
    "k4": _taa_rows,
    "k5": _k5,
}

CASES = {c[0]: c for c in gather.probe_cases(np.random.default_rng(0), SCALE)}


def _jax_args(args):
    return tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)


@pytest.mark.parametrize("name", sorted(CASES))
def test_probe_plain_matches_jax(name):
    _name, replaces, wrapper, args = CASES[name]
    assert replaces.startswith("benchmark/probes/")
    fn, plain = gather.WRAPPERS[wrapper]
    got = fn(*gather.to_device(args, "cpu"))
    assert got.dtype == torch.int32
    want = np.asarray(JAX[name](*_jax_args(args)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(plain(*gather.to_device(args, "cpu")).numpy(), want)


def test_probe_cases_cover_every_pallas_probe():
    assert sorted(CASES) == sorted(JAX)
    assert {c[2] for c in CASES.values()} == set(gather.WRAPPERS)


@pytest.mark.parametrize("mode", gather.MODES)
def test_gather_chain_wraps_like_int32(mode):
    """Full-range int32 tables (as the pair plane's mask words are): the sums
    wrap at 32 bits and `%` is the floor modulo, as in JAX."""
    rng = np.random.default_rng(4)
    table = rng.integers(-2**31, 2**31, (57, 300), dtype=np.int64).astype(np.int32)
    if mode == "sum":
        args = (table, rng.integers(0, 300, 500, dtype=np.int32),
                rng.integers(-2**31, 2**31, 64, dtype=np.int64).astype(np.int32), 30, mode)
        want = _k_scan(*_jax_args(args))
    else:
        args = (table[:4], rng.integers(0, 300, (4, 700), dtype=np.int32), None, 30, mode)
        want = _k_d(*_jax_args(args))
    got = gather.gather_chain(*gather.to_device(args, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_chain_reads_a_strided_table():
    """Mode sum on the transposed view of a row-major plane (how the probe
    runs on the pair plane) equals it on a contiguous copy."""
    rng = np.random.default_rng(5)
    plane = torch.from_numpy(rng.integers(-2**31, 2**31, (400, 57), dtype=np.int64).astype(np.int32))
    init = torch.from_numpy(rng.integers(0, 400, 256, dtype=np.int32))
    c = torch.from_numpy(rng.integers(0, 400, 64, dtype=np.int32))
    got = gather.gather_chain(plane.T, init, c, 25, "sum")
    want = gather.gather_chain(plane.T.contiguous(), init, c, 25, "sum")
    assert torch.equal(got, want)


def test_take_along_rejects_a_shape_that_does_not_broadcast():
    with pytest.raises(ValueError):
        gather.take_along(torch.zeros((4, 8), dtype=torch.int32),
                          torch.zeros((3, 8), dtype=torch.int32), 1)


@pytest.mark.parametrize("bad", [-1, 40])
@pytest.mark.parametrize("wrapper", ["gather_rows", "take_along", "gather_chain"])
def test_wrapper_rejects_an_index_out_of_range(wrapper, bad):
    """An index (G1, G2) or initial state (G3) outside the table raises."""
    table = torch.arange(40 * 40, dtype=torch.int32).reshape(40, 40)
    idx = torch.tensor([0, 39, bad, 5], dtype=torch.int32)
    args = {
        "gather_rows": (table, idx),
        "take_along": (table, idx[None, :], 1),
        "gather_chain": (table, idx, torch.zeros(4, dtype=torch.int32), 3, "sum"),
    }[wrapper]
    with pytest.raises(ValueError, match="want \\[0, 40\\)"):
        gather.WRAPPERS[wrapper][0](*args)


EDGES = {c[0]: c for c in gather.edge_cases(np.random.default_rng(1), "cpu")}


def _jax_edge(name, args):
    if name == "gather_rows":
        return np.asarray(jnp.take(jnp.asarray(args[0].numpy()), jnp.asarray(args[1].numpy()),
                                   axis=0))
    if name == "scale2":
        return np.asarray(jnp.asarray(args[0].numpy()) * 2)
    if name == "gather_chain":
        table, init, c, steps, mode = args
        k = _k_scan if mode == "sum" else _k_d
        return np.asarray(k(jnp.asarray(table.contiguous().numpy()), jnp.asarray(init.numpy()),
                            None if c is None else jnp.asarray(c.numpy()), steps, mode))
    table, index, axis = (a.numpy() if isinstance(a, torch.Tensor) else a for a in args)
    shape = gather._take_shape(args[0], args[1], axis)
    return np.asarray(jnp.take_along_axis(jnp.asarray(table),
                                          jnp.broadcast_to(jnp.asarray(index), shape), axis=axis))


@pytest.mark.parametrize("label", sorted(EDGES))
def test_edge_case_matches_jax(label):
    """G1, G2, G3 (both modes) and G4 at the edge shapes that chip_smoke.py
    holds the kernels to on the card: the wrapper (plain version on the
    CPU) equals jax.numpy."""
    _label, name, args = EDGES[label]
    got = gather.WRAPPERS[name][0](*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_edge(name, args))


@pytest.mark.parametrize("k", range(4))
def test_scale2_out_shares_the_offset_of_x(k):
    """G4's output for the view x[k:] is contiguous, of its shape, and at its
    offset within 16 bytes, so that both take the vector body together."""
    x = torch.arange(4 * 64 + 5, dtype=torch.int32)[k:]
    out, head, nvec = gather.scale2_out(x)
    assert out.is_contiguous() and out.shape == x.shape and out.dtype == torch.int32
    assert (out.data_ptr() - x.data_ptr()) % 16 == 0
    assert (head, nvec) == gather.scale2_plan(x.data_ptr(), x.data_ptr(), x.numel())[1:]


@pytest.mark.parametrize("bad", [
    torch.zeros(0, dtype=torch.int32),
    torch.zeros(8, dtype=torch.int64),
    torch.zeros((4, 4), dtype=torch.int32).T,
])
def test_scale2_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError, match="scale2"):
        gather.scale2(bad)


@pytest.mark.parametrize("x_off", [0, 4, 8, 12])
@pytest.mark.parametrize("buf_off", [0, 4, 12])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 7, 1023, 4 * 2**20 + 3])
def test_scale2_plan_splits_on_16_byte_boundaries(x_off, buf_off, n):
    """The output, cut from a buffer 3 elements longer, starts at x's offset
    within 16 bytes; the vector body starts on a 16-byte boundary of both
    and covers all but fewer than 4 elements past the head."""
    x_addr, buf_addr = 4096 + x_off, 8192 + buf_off
    shift, head, nvec = gather.scale2_plan(x_addr, buf_addr, n)
    out_addr = buf_addr + 4 * shift
    assert 0 <= shift <= 3 and (out_addr - x_addr) % 16 == 0
    assert head == min(n, (16 - x_off) % 16 // 4)
    assert 0 <= n - head - 4 * nvec < 4
    if nvec:
        assert (x_addr + 4 * head) % 16 == 0 and (out_addr + 4 * head) % 16 == 0


@pytest.mark.parametrize("n", [8 * 128, 393_230 * 57, 4 * 2**20 + 3])
def test_scale2_plan_on_aligned_tensors(n):
    """Aligned x and buffer (as torch.empty gives them): no shift, no head,
    every whole vector in the body ([8, 128] and the pair plane: all)."""
    assert gather.scale2_plan(0, 512, n) == (0, 0, n // 4)


def test_scale2_plan_refuses_a_misaligned_word():
    with pytest.raises(ValueError, match="4-byte aligned"):
        gather.scale2_plan(4098, 512, 10)


def _take_plan(table, index, axis, sms=132):
    """G2's plan, the grid csrc/gather_probe.cu launches for it (its blocks
    and threads a block), and the outputs."""
    A, B, Q, _si0, _si1 = gather.take_along_geometry(table, index, axis)
    form, tile = gather.take_along_plan(A, B, Q, axis, sms)
    if form == gather.AXIS0:
        blocks, threads = min(132 * 16, -(-Q * B // tile)), tile
    else:
        blocks = A * -(-Q // tile)
        threads = gather.SHARED_THREADS if form == gather.SHARED else tile
    return form, tile, blocks, threads, Q * (A if axis == 1 else B)


@pytest.mark.parametrize("case", [c[0] for c in gather.probe_cases(np.random.default_rng(0))
                                  if c[2] == "take_along"] + ["pair plane"])
def test_take_along_plan_fills_the_card(case):
    """At every Pallas probe shape (uncut) and on the transposed pair plane,
    G2's grid holds a thread for each of 256 threads on each of the 132 SMs
    wherever the outputs allow; the row copy to shared memory is chosen at
    k_lane and k2 (at least a block for every two SMs), not at k_c (32
    blocks) nor for the plane (its rows do not fit)."""
    if case == "pair plane":
        args = (torch.empty((57, 393_230), dtype=torch.int32),
                torch.empty((1, 60_608), dtype=torch.int32), 1)
    else:
        cases = {c[0]: c for c in gather.probe_cases(np.random.default_rng(0))}
        args = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                     for a in cases[case][3])
    form, _tile, blocks, threads, outputs = _take_plan(*args)
    assert blocks * threads >= min(132 * 256, outputs)
    expected = {"k_lane": gather.SHARED, "k2": gather.SHARED, "pair plane": gather.DIRECT,
                "k_a": gather.DIRECT, "k_b": gather.AXIS0, "k_c": gather.DIRECT}
    assert form == expected[case]


FORM_OF_EDGE = {
    "take_along shared-memory form": gather.SHARED,
    "take_along broadcast index [1, Q] off the tiles": gather.SHARED,
    "take_along row wider than shared memory, full index": gather.DIRECT,
    "take_along row wider than shared memory, broadcast": gather.DIRECT,
    "take_along full index off the tiles": gather.DIRECT,
}


@pytest.mark.parametrize("label", sorted(l for l in EDGES if l.startswith("take_along")))
def test_take_along_plan_covers_every_output(label):
    """Each form's grid reaches every output: shared and direct blocks cover
    every tile of every row (a shared tile is a multiple of its 1,024
    threads and at least a quarter of the row; a direct block at most 256
    threads), axis 0 has a block of 256 threads."""
    table, index, axis = EDGES[label][2]
    A, B = table.shape
    form, tile, blocks, threads, outputs = _take_plan(table, index, axis)
    Q = outputs // (A if axis == 1 else B)
    if form == gather.SHARED:
        assert tile % gather.SHARED_THREADS == 0 and 4 * tile >= B and 4 * B <= gather.SMEM_MAX
    if form in (gather.SHARED, gather.DIRECT):
        assert axis == 1 and blocks * tile >= A * Q and blocks % A == 0
        assert form == gather.SHARED or tile <= gather.TAKE_THREADS
    else:
        assert form == gather.AXIS0 and axis == 0 and blocks >= 1
        assert threads == gather.TAKE_THREADS
    assert FORM_OF_EDGE.get(label, form) == form


def test_take_along_refuses_a_non_contiguous_index():
    table = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    with pytest.raises(ValueError, match="want a contiguous tensor"):
        gather.take_along(table, torch.zeros((4, 3), dtype=torch.int32).T, 1)


@pytest.mark.parametrize("W, contiguous, lanes, want", [
    (1, True, 1, 8), (1, False, 3, 8), (24, False, 8192, 8), (57, True, 1001, 8),
    (57, False, 8447, 8), (24, True, 8449, 1), (24, False, 8449, 1), (1, True, 60_607, 1),
    (57, False, 60_608, 1), (57, True, 8449, 8), (57, True, 33_792, 8),
    (57, True, 33_793, 4), (57, True, 60_608, 4), (26, True, 20_001, 8), (25, True, 20_001, 1),
])
def test_chain_plan(W, contiguous, lanes, want):
    """G3's threads a lane on 132 SMs: 8 while 8 threads a lane stay within
    512 threads an SM (k_scan's 8,192 lanes), then one thread a lane, except
    rows of 8 or more 16-byte vectors (26 words at a 4-byte offset span up to 8,
    25 up to 7; the pair plane's 57 up to 15): 8 while the card holds every
    thread (33,792 lanes), then 4 (the plane's 60,608).  Lane counts that
    are no multiple of the group make whole groups of threads."""
    G = gather.chain_plan(W, contiguous, lanes, 132)
    assert G == want and G in gather.CHAIN_GROUPS


def test_chain_edge_cases_cover_the_groups_and_forms():
    """G3 mode sum's edge cases: both forms at W = 1, 24 and 57, lane counts that no
    group divides, a step of two load rounds in each form, and no steps."""
    chains = [args for label, name, args in EDGES.values()
              if name == "gather_chain" and args[4] == "sum"]
    forms = {(t.shape[0], t.stride(0) == 1) for t, *_ in chains}
    assert {(W, c) for W in (1, 24, 57) for c in (True, False)} <= forms
    assert (100, True) in forms and (40, False) in forms
    assert any(init.numel() % 8 and init.numel() > 8 for _t, init, *_ in chains)
    assert any(steps == 0 for *_a, steps, _m in chains)
    assert any(t.storage_offset() % 4 for t, *_ in chains)


def test_row_gather_edge_cases_cover_both_paths():
    """G1's edge cases: rows of C = 1, 57 and 128 words, C = 16 with a row
    count that fills no warp of 8 rows, planes off the 16-byte boundary
    (the word path at C % 4 == 0), and more items than one a thread on 132
    SMs x 8 blocks x 256 threads."""
    rows = [args for label, name, args in EDGES.values() if name == "gather_rows"]
    assert {1, 57, 128, 16} <= {p.shape[1] for p, _i in rows}
    assert any(p.shape[1] == 16 and i.numel() % 8 for p, i in rows)
    assert any(p.shape[1] % 4 == 0 and p.storage_offset() % 4 for p, _i in rows)
    assert any(i.numel() * p.shape[1] > 132 * 8 * 256 for p, i in rows)


def _elem_grid(W, N, sx, M, sms=132):
    """G3 mode elem's form on `sms` SMs and the grid csrc/gather_probe.cu
    launches for it: (form, blocks, threads a block)."""
    form = gather.chain_elem_plan(W, N, sx, M, sms)
    if form == gather.SHARED:
        tile = gather.chain_elem_tile(M)
        return form, W * -(-M // tile), tile
    return form, -(-W * M // gather.TAKE_THREADS), gather.TAKE_THREADS


@pytest.mark.parametrize("case, W, N, sx, M, want", [
    ("k_d", 8, 8192, 1, 8192, gather.SHARED),
    ("k_d's table strided (its transpose's view)", 8, 8192, 8, 8192, gather.DIRECT),
    ("rows of the most words shared memory holds", 8, gather.SMEM_MAX // 4, 1, 14_529,
     gather.SHARED),
    ("rows one word past shared memory", 8, gather.SMEM_MAX // 4 + 1, 1, 14_529, gather.DIRECT),
    ("the L2 round trip: 32 chains over a direction's plane", 1, 196_615 * 57, 1, 32,
     gather.DIRECT),
    ("the L1 round trip: 32 chains over a 4 KB table", 1, 1024, 1, 32, gather.DIRECT),
    ("too few lanes to pay for the row", 8, 8192, 1, 2047, gather.DIRECT),
    ("too few blocks for the card", 4, 8192, 1, 8192, gather.DIRECT),
])
def test_chain_elem_plan_fills_the_card(case, W, N, sx, M, want):
    """G3 mode elem on 132 SMs: k_d's [8, 8192] x 8,192 lanes stages its
    rows (128 blocks of 512 lanes, a block for nearly every SM) and its grid
    holds a thread for every lane; strided rows, rows past shared memory
    (58,112 words), rows with fewer than N / 4 lanes and grids of fewer
    than 66 blocks read in place, the round-trip yardsticks among them."""
    form, blocks, threads = _elem_grid(W, N, sx, M)
    assert form == want
    assert blocks * threads >= W * M and threads <= gather.SHARED_THREADS
    if case == "k_d":
        assert (blocks, threads) == (128, 512)


@pytest.mark.parametrize("label", sorted(l for l, (_l, name, args) in EDGES.items()
                                         if name == "gather_chain" and args[4] == "elem"))
def test_chain_elem_plan_covers_every_lane(label):
    """At every mode elem edge case each form's grid reaches every lane: a
    shared block serves one row's tile of at most ELEM_TILE lanes (a whole
    number of warps, no more than a row's lanes rounded up to one), so the
    blocks of a row cover its M lanes; the plan stages only contiguous rows
    that fit in shared memory."""
    table, init, _c, _steps, _mode = EDGES[label][2]
    (W, N), M = table.shape, init.shape[1]
    form, blocks, threads = _elem_grid(W, N, table.stride(1), M)
    tile = gather.chain_elem_tile(M)
    assert tile % 32 == 0 and tile <= gather.ELEM_TILE and tile < M + 32
    assert blocks * threads >= W * M
    if form == gather.SHARED:
        assert table.stride(1) == 1 and 4 * N <= gather.SMEM_MAX and blocks % W == 0
    want = {"strided": gather.DIRECT, "past shared memory": gather.DIRECT,
            "k_d's shape": gather.SHARED, "the longest row": gather.SHARED,
            "4 bytes off": gather.SHARED}
    for key, form_wanted in want.items():
        if key in label:
            assert form == form_wanted


def test_chain_elem_edge_cases_cover_the_limits():
    """G3 mode elem's edge cases: W = 1 and 8, N = 1, 8,192 and each side of
    the shared-memory limit, 1, 3 and 1,001 lanes a row and a row whose
    last tile holds one lane, 0 and 1 steps, a strided table and one 4 bytes
    off its allocation, words near INT_MAX, initial states 0 and N - 1."""
    elems = [args for _l, name, args in EDGES.values()
             if name == "gather_chain" and args[4] == "elem"]
    limit = gather.SMEM_MAX // 4
    assert {1, 8} <= {t.shape[0] for t, *_ in elems}
    assert {1, 8192, limit, limit + 1} <= {t.shape[1] for t, *_ in elems}
    assert {1, 3, 1001} <= {i.shape[1] for _t, i, *_ in elems}
    assert any(i.shape[1] % gather.ELEM_TILE == 1 for _t, i, *_ in elems)
    assert {0, 1} <= {steps for *_a, steps, _m in elems}
    assert any(t.stride(1) != 1 for t, *_ in elems)
    assert any(t.storage_offset() % 4 for t, *_ in elems)
    assert any(int(t.max()) > 2**31 - 1 - t.shape[1] - steps for t, _i, _c, steps, _m in elems)
    assert any({0, t.shape[1] - 1} <= set(i.unique().tolist()) and i.unique().numel() == 2
               for t, i, *_ in elems)
