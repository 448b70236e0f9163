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
