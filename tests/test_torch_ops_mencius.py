"""The port's Mencius vote plane (the plain PyTorch version, which the
CUDA kernel is held against on the card) against the JAX package's
``reference_mencius_vote`` and its Pallas ``fused_mencius_vote`` in
interpret mode: the same numpy inputs, all three outputs equal, dtypes
included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import mencius as jme
from frankenpaxos_tpu_torch.ops import mencius as tme
from frankenpaxos_tpu_torch.ops import registry

SHAPES = [(7, 16, 3), (4, 32, 5), (5, 8, 3)]  # L, W, A (ragged, f=2, small)
CASES = ["random", "all_now", "all_inf"]

_DT = {
    np.dtype("int32"): torch.int32,
    np.dtype("bool"): torch.bool,
}


def _args(shape, case="random"):
    return tme.example_mencius_vote_args(
        np.random.default_rng(sum(shape)), *shape, case=case
    )


def _jax_args(args):
    return tuple(
        jnp.asarray(a) if isinstance(a, np.ndarray) else jnp.int32(a)
        for a in args
    )


def _assert_equal(jax_outs, port_outs):
    assert len(jax_outs) == len(port_outs) == len(tme.MENCIUS_VOTE_OUTS)
    for name, j, p in zip(tme.MENCIUS_VOTE_OUTS, jax_outs, port_outs):
        j = np.asarray(j)
        assert _DT[j.dtype] == p.dtype, f"{name}: {j.dtype} vs {p.dtype}"
        assert tuple(j.shape) == tuple(p.shape), name
        np.testing.assert_array_equal(j, p.numpy(), err_msg=name)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_reference(shape, case):
    args = _args(shape, case)
    port = tme.reference_mencius_vote(*registry.to_torch(args, "cpu"))
    _assert_equal(jme.reference_mencius_vote(*_jax_args(args)), port)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_interpret_kernel(shape, case):
    args = _args(shape, case)
    port = tme.reference_mencius_vote(*registry.to_torch(args, "cpu"))
    kern = jme.fused_mencius_vote(
        *_jax_args(args), block=max(shape[0] // 2, 1), interpret=True
    )
    _assert_equal(kern, port)


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_on_cpu_is_the_plain_version(shape):
    registry.reset_launches()
    args = registry.to_torch(_args(shape), "cpu")
    got = tme.fused_mencius_vote(*args)
    want = tme.reference_mencius_vote(*args)
    for name, g, w in zip(tme.MENCIUS_VOTE_OUTS, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert registry.LAUNCHES["mencius_vote"] == 0


def test_example_inputs_reach_every_branch():
    """The random inputs vote now, schedule and drop replies, keep earlier
    votes and count both kinds; the edge cases do what they say."""
    p2a, voted, p2b, lat, deliv, t = registry.to_torch(_args((64, 32, 3)), "cpu")
    new_voted, new_p2b, nv = tme.reference_mencius_vote(p2a, voted, p2b, lat, deliv, t)
    arrived = p2a == t
    assert bool((arrived & deliv & (new_p2b < p2b)).any())  # min-write wins
    assert bool((arrived & deliv & (new_p2b == p2b)).any())  # earlier reply
    assert bool((arrived & ~deliv).any()) and bool((voted & ~arrived).any())
    assert int(nv.max()) == 3 and int(nv.min()) == 0
    now = registry.to_torch(_args((7, 16, 3), "all_now"), "cpu")
    assert bool(tme.reference_mencius_vote(*now)[0].all())
    never = registry.to_torch(_args((7, 16, 3), "all_inf"), "cpu")
    out = tme.reference_mencius_vote(*never)
    assert not bool(out[0].any()) and int(out[2].sum()) == 0


def test_registration():
    plane = registry.PLANES["mencius_vote"]
    assert plane.backend == "mencius"
    assert plane.source == "frankenpaxos_tpu_torch/csrc/mencius.cu"
    assert plane.replaces.startswith(
        "frankenpaxos_tpu/ops/mencius.py:81 fused_mencius_vote"
    )


def test_wrapper_rejects_mixed_devices():
    args = list(registry.to_torch(_args((4, 8, 3)), "cpu"))
    args[2] = args[2].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        tme.fused_mencius_vote(*args)


def _zeros(L, W, A):
    """Zero tensors of the plane's shapes and dtypes (``t`` = 40 last)."""
    i32 = dict(dtype=torch.int32)
    shape = (L, W, A)
    return [
        torch.zeros(shape, **i32), torch.zeros(shape, dtype=torch.bool),
        torch.zeros(shape, **i32), torch.zeros(shape, **i32),
        torch.zeros(shape, dtype=torch.bool), 40,
    ]


@pytest.mark.parametrize("shape,skew,block,route", [
    ((3334, 32, 3), None, 0, "vector"),  # the main path
    ((33334, 32, 3), None, 0, "vector"),  # 100,002 acceptors
    ((64, 32, 5), None, 0, "vector"),  # f = 2
    ((8, 4, 9), None, 0, "vector"),  # f = 4, the largest templated A
    ((4, 6, 3), None, 0, "vector"),  # W % 4 != 0, L * W % 4 == 0
    ((5, 3, 3), None, 0, "general"),  # L * W % 4 != 0
    ((7, 16, 11), None, 0, "general"),  # A = 11 (f = 5)
    ((7, 16, 1), None, 0, "general"),  # A = 1 (f = 0)
    ((3334, 32, 3), 0, 0, "general"),  # Phase2a one element off
    ((3334, 32, 3), 1, 0, "general"),  # a bool plane one element off
    ((3334, 32, 3), 4, 0, "general"),  # the delivery plane off
    ((3334, 32, 3), None, 100, "vector"),  # a block of part warps
    ((3334, 32, 3), None, 512, "vector"),  # a block past 256
    ((5, 3, 3), None, 100, "general"),  # the general route at that block
])
def test_mencius_vote_route(shape, skew, block, route):
    """The route the wrapper asks the kernel for, from L * W, A and the
    planes' 16-byte alignment (the vector route runs 32 * A threads a CTA,
    so the block sizes only the general route's); prepared_launch on CPU
    tensors takes it and packs its code and threads."""
    args = _zeros(*shape)
    if skew is not None:
        args[skew] = registry.misaligned([args[skew]])[0]
        assert args[skew].is_contiguous() and args[skew].data_ptr() % 16
    assert tme.mencius_vote_route(*args) == route
    launch, outs = tme.prepared_launch(*args, block)
    assert launch.route == route
    ints = list(launch.packed[1])
    assert ints[:4] == [*shape, 40]
    assert ints[4:] == [block or 256, registry.ROUTES.index(route)]
    assert [tuple(o.shape) for o in outs] == [shape, shape, shape[:2]]


def test_mencius_vote_needed_bytes_counted_by_hand():
    """(L, W, A) = (1, 2, 2) at t = 40: the Phase2a of cells (0, 0) and
    (1, 0) arrives now, the reply of (0, 0) is delivered and that of
    (1, 0) dropped; the other two cells carry their vote. The vector
    route also reads the vote bits of the two arrivals."""
    INF = 2**30
    args = _zeros(1, 2, 2)
    args[0][:] = torch.tensor([[[40, 7], [40, INF]]], dtype=torch.int32)
    args[3][:] = 2
    args[4][:] = torch.tensor([[[True, True], [False, True]]])
    want = (
        4 * (4 + 4)  # every Phase2a tick and Phase2b tick
        + 2  # the vote bits of the two cells with no arrival
        + 2  # the delivery bits of the two arrivals
        + 4  # the latency of the delivered one
        + 4 * (1 + 4) + 2 * 4  # vote bit and Phase2b tick out; counts
    )
    assert tme.mencius_vote_needed_bytes(args) == want == 68
    assert tme.mencius_vote_route_bytes(args) == want + 2 == 70


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES + [(3334, 32, 3)])
def test_mencius_vote_reads_nothing_outside_the_needed_set(shape, case):
    """Every input cell the needed bytes leave out overwritten with garbage
    from a seeded generator: the vote bit of each cell whose Phase2a
    arrives now, the delivery bit of each cell whose Phase2a does not,
    the latency of each cell whose reply is not scheduled now. The plain
    version's outputs do not change, so a kernel may leave those cells
    unread. The needed bytes count exactly the cells kept, and the vector
    route's bytes the vote bits of the arrivals as well."""
    args = _args(shape, case)
    p2a, voted, p2b, lat, deliv, t = args
    arrived = p2a == t
    keep_lat = arrived & deliv
    rng = np.random.default_rng(99)
    poisoned = list(args)
    poisoned[1] = np.where(arrived, rng.random(shape) < 0.5, voted)
    poisoned[4] = np.where(arrived, deliv, rng.random(shape) < 0.5)
    poisoned[3] = np.where(
        keep_lat, lat, rng.integers(-(2**31), 2**31, shape, dtype=np.int64)
    ).astype(np.int32)
    want = tme.reference_mencius_vote(*registry.to_torch(args, "cpu"))
    got = tme.reference_mencius_vote(*registry.to_torch(poisoned, "cpu"))
    for name, w, g in zip(tme.MENCIUS_VOTE_OUTS, want, got):
        assert torch.equal(w, g), name
    cells, slots = p2a.size, p2a.size // shape[2]
    needed = cells * 9 + 4 * int(keep_lat.sum()) + cells * 5 + slots * 4
    targs = registry.to_torch(args, "cpu")
    assert tme.mencius_vote_needed_bytes(targs) == needed
    assert tme.mencius_vote_route_bytes(targs) == needed + int(arrived.sum())
    if case == "random":  # something poisoned in every field
        assert arrived.any() and (~arrived).any() and (~keep_lat).any()


def _vector_route_model(args):
    """A numpy model of csrc/mencius.cu mencius_vote_vec's index
    arithmetic: CTA b of ceil(quads / 32) owns slot quads 32b .. 32b + 31
    with 32 * A threads; thread x owns the 16-byte vector of cells from c0
    = 4 * (32bA + x) (a vector of each int32 plane, a 4-byte word of each
    bool plane) and stores the same; the CTA's counts meet in a shared
    array of 128 * A bytes, and its thread x < 32 sums slot quad 32b + x's
    4A of them into one 16-byte vector of counts. Threads past the last
    cell, and quads past the last, are masked. Each output starts as a
    sentinel, and each store asserts that it lands where nothing was
    written yet."""
    p2a, voted, p2b, lat, deliv, t = args
    L, W, A = p2a.shape
    assert (L * W) % 4 == 0
    quads = L * W // 4
    p2a_f, voted_f, p2b_f, lat_f, deliv_f = (
        x.reshape(-1) for x in (p2a, voted, p2b, lat, deliv)
    )
    voted_w = voted_f.astype(np.uint8).view(np.uint32)
    o_p2b = np.full(p2a.size, -3, np.int32)
    o_voted = np.full(p2a.size, 7, np.uint8)
    o_nv = np.full(L * W, -3, np.int32)
    for b in range(-(-quads // 32)):
        shared = np.full(32 * 4 * A, 0, np.uint8)
        for x in range(32 * A):
            c0 = (32 * b * A + x) * 4
            if c0 >= quads * 4 * A:  # masked
                continue
            assert (c0 * 4) % 16 == 0  # the int32 vector is aligned
            word, out_word = int(voted_w[c0 // 4]), 0
            for j in range(4):
                now = p2a_f[c0 + j] == t
                v = True if now else ((word >> (8 * j)) & 0xFF) != 0
                pb = p2b_f[c0 + j]
                if now and deliv_f[c0 + j]:
                    cand = (np.int64(t) + np.int64(lat_f[c0 + j])).astype(np.int32)
                    pb = min(pb, cand)
                assert o_p2b[c0 + j] == -3 and o_voted[c0 + j] == 7
                o_p2b[c0 + j] = pb
                out_word |= int(v) << (8 * j)
                shared[4 * x + j] = int(v and pb <= t)
            o_voted[c0:c0 + 4] = [(out_word >> (8 * j)) & 0xFF for j in range(4)]
        for x in range(32):  # after the barrier
            q = 32 * b + x
            if q >= quads:
                continue
            assert (o_nv[4 * q: 4 * q + 4] == -3).all()
            o_nv[4 * q: 4 * q + 4] = [
                int(shared[(4 * x + l) * A:(4 * x + l + 1) * A].sum())
                for l in range(4)
            ]
    return (
        o_voted.reshape(L, W, A).astype(bool), o_p2b.reshape(L, W, A),
        o_nv.reshape(L, W),
    )


@pytest.mark.parametrize("A", [1, 3, 5, 11])
@pytest.mark.parametrize("LW", [(7, 4), (3, 12), (33, 8)])
def test_vector_route_model_matches_plain_version(A, LW):
    """The route's index arithmetic, modelled in numpy (a 16-byte vector
    of cells a thread, 32 slot quads a CTA, the counts joined in shared
    memory, the tail masked), gives the plain version's outputs, and every
    output cell is written exactly once, for A = 1, 3, 5, 11 and L * W of
    28, 36 and 264 slots (a last CTA of 7, 9 and 2 quads). (L * W % 4 != 0
    takes the general route: test_mencius_vote_route.)"""
    for case in CASES:
        args = _args((*LW, A), case)
        model = _vector_route_model(args)
        plain = tme.reference_mencius_vote(*registry.to_torch(args, "cpu"))
        for name, m, p in zip(tme.MENCIUS_VOTE_OUTS, model, plain):
            np.testing.assert_array_equal(m, p.numpy(), err_msg=f"{case} {name}")
