"""The port's Compartmentalized grid-vote plane (the plain PyTorch
version, which the CUDA kernel is held against on the card) against the
JAX package's ``reference_grid_vote`` and its Pallas ``fused_grid_vote``
in interpret mode, and the port's six-pass twin ``unfused_grid_vote``
against the Pallas ``unfused_grid_vote`` in interpret mode: the same
numpy inputs, all ten outputs equal, dtypes included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import compartmentalized as jcz
from frankenpaxos_tpu_torch.ops import compartmentalized as tcz
from frankenpaxos_tpu_torch.ops import registry

SHAPES = [(2, 2, 3, 7, 16), (2, 3, 2, 5, 32), (3, 2, 3, 4, 8)]  # R, C, NR, G, W

_DT = {
    np.dtype("int8"): torch.int8,
    np.dtype("int16"): torch.int16,
    np.dtype("int32"): torch.int32,
    np.dtype("bool"): torch.bool,
}


def _args(shape):
    return tcz.example_grid_vote_args(np.random.default_rng(sum(shape)), *shape)


def _jax_args(args):
    return tuple(
        jnp.asarray(a) if isinstance(a, np.ndarray) else jnp.int32(a)
        for a in args
    )


def _assert_equal(jax_outs, port_outs):
    assert len(jax_outs) == len(port_outs) == len(tcz.GRID_VOTE_OUTS)
    for name, j, p in zip(tcz.GRID_VOTE_OUTS, jax_outs, port_outs):
        j = np.asarray(j)
        assert _DT[j.dtype] == p.dtype, f"{name}: {j.dtype} vs {p.dtype}"
        assert tuple(j.shape) == tuple(p.shape), name
        np.testing.assert_array_equal(j, p.numpy(), err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_reference(shape):
    args = _args(shape)
    port = tcz.reference_grid_vote(
        *registry.to_torch(args, "cpu"), retry_timeout=8
    )
    _assert_equal(jcz.reference_grid_vote(*_jax_args(args), retry_timeout=8), port)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_interpret_kernel(shape):
    args = _args(shape)
    G = shape[3]
    port = tcz.reference_grid_vote(
        *registry.to_torch(args, "cpu"), retry_timeout=8
    )
    kern = jcz.fused_grid_vote(
        *_jax_args(args), block=max(G // 2, 1), interpret=True,
        retry_timeout=8,
    )
    _assert_equal(kern, port)


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_on_cpu_is_the_plain_version(shape):
    registry.reset_launches()
    args = registry.to_torch(_args(shape), "cpu")
    got = tcz.fused_grid_vote(*args, retry_timeout=8)
    want = tcz.reference_grid_vote(*args, retry_timeout=8)
    for name, g, w in zip(tcz.GRID_VOTE_OUTS, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert registry.LAUNCHES["compartmentalized_grid_vote"] == 0


def test_example_inputs_reach_every_branch():
    """The example inputs vote, drop votes, choose, time out and re-send,
    and wrap the ring ordinals, so the kernel check covers every branch."""
    args = registry.to_torch(_args((2, 2, 3, 64, 32)), "cpu")
    (p2a, p2b, rep, status, last_send, rep_exec, newly, timed, votes,
     dropped) = tcz.reference_grid_vote(*args, retry_timeout=8)
    assert int(newly.sum()) > 0 and int(timed.sum()) > 0
    assert int(votes.sum()) > int(dropped.sum()) > 0
    assert bool((rep_exec > args[5]).any())
    assert bool((args[6] >= 32).any())  # heads past W


def test_registration():
    plane = registry.PLANES["compartmentalized_grid_vote"]
    assert plane.backend == "compartmentalized"
    assert plane.source == "frankenpaxos_tpu_torch/csrc/compartmentalized.cu"
    assert plane.replaces.startswith(
        "frankenpaxos_tpu/ops/compartmentalized.py:289 fused_grid_vote"
    )
    assert (tcz.EMPTY, tcz.PROPOSED, tcz.CHOSEN) == (
        jcz.EMPTY, jcz.PROPOSED, jcz.CHOSEN,
    )


def test_wrapper_rejects_mixed_devices():
    args = list(registry.to_torch(_args((2, 2, 3, 4, 8)), "cpu"))
    args[3] = args[3].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        tcz.fused_grid_vote(*args, retry_timeout=8)


def test_watermark_live_range_tests_the_ring_position():
    """A quirk of the reference that the port keeps: the replica
    watermark's live range compares the ring POSITION w, not the slot's
    ordinal, with next - head. Here head = 5, next = 25 and every slot is
    chosen and arrived at the replica: an ordinal range would let the
    watermark reach 25, the position range stops it at 5 + 15 = 20."""
    R = C = NR = G = 1
    W = 32
    i32 = np.int32
    args = (
        np.full((R, C, G, W), 32767, np.int16),  # p2a: nothing in flight
        np.full((R, C, G, W), 32767, np.int16),  # p2b
        np.zeros((NR, G, W), np.int16),  # rep_arrival: landed
        np.full((G, W), tcz.CHOSEN, np.int8),
        np.full((G, W), 2**30, i32),  # last_send
        np.array([[5]], i32),  # rep_exec
        np.array([5], i32),  # head
        np.array([25], i32),  # next_slot
        np.ones((G, W), bool),
        np.ones((R, C, G, W), bool),
        np.ones((R, C, G, W), bool),
        np.ones((R, C, G, W), i32),
        np.ones((R, C, G, W), i32),
        np.ones((NR, G, W), i32),
        40,
    )
    port = tcz.reference_grid_vote(*registry.to_torch(args, "cpu"), retry_timeout=8)
    ref = jcz.reference_grid_vote(*_jax_args(args), retry_timeout=8)
    assert int(port[5][0, 0]) == int(np.asarray(ref[5])[0, 0]) == 20


@pytest.mark.parametrize("shape", [(2, 2, 3, 2, 2048), (2, 3, 2, 1, 1030)])
def test_kernel_checks_accept_w_over_1024(shape):
    """The wrapper's checks take W > 1024 (one CTA per group on the card);
    the plain version there equals the JAX reference."""
    args = _args(shape)
    torch_args = registry.to_torch(args, "cpu")
    _, outs = tcz.prepared_launch(*torch_args, retry_timeout=8)
    port = tcz.reference_grid_vote(*torch_args, retry_timeout=8)
    assert [(o.shape, o.dtype) for o in outs] == [(p.shape, p.dtype) for p in port]
    _assert_equal(jcz.reference_grid_vote(*_jax_args(args), retry_timeout=8), port)


UNFUSED_SHAPES = [(2, 2, 3, 8, 8), (2, 3, 2, 7, 16)]  # R, C, NR, G, W


@pytest.mark.parametrize("shape", UNFUSED_SHAPES)
def test_unfused_matches_jax_interpret_kernel(shape):
    """The six-pass wrapper on CPU tensors (the six plain passes) equals
    the Pallas six-pass kernel, all ten outputs and dtypes, tolerance 0."""
    registry.reset_launches()
    args = _args(shape)
    port = tcz.unfused_grid_vote(
        *registry.to_torch(args, "cpu"), retry_timeout=8
    )
    kern = jcz.unfused_grid_vote(
        *_jax_args(args), block=16, interpret=True, retry_timeout=8
    )
    _assert_equal(kern, port)
    assert registry.LAUNCHES[tcz.UNFUSED_PLANE] == 0


@pytest.mark.parametrize("shape", SHAPES + UNFUSED_SHAPES)
def test_unfused_plain_equals_fused_plain(shape):
    """The six plain passes chained compute the one-pass plain version."""
    args = registry.to_torch(_args(shape), "cpu")
    got = tcz.reference_unfused_grid_vote(*args, retry_timeout=8)
    want = tcz.reference_grid_vote(*args, retry_timeout=8)
    for name, g, w in zip(tcz.GRID_VOTE_OUTS, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("shape", [(2, 2, 3, 2, 2048), (2, 3, 2, 1, 1030)])
def test_unfused_kernel_checks_accept_w_over_1024(shape):
    """The six-pass wrapper's checks take W > 1024 and allocate the
    fused wrapper's outputs; its plain passes there equal the JAX
    reference."""
    args = _args(shape)
    torch_args = registry.to_torch(args, "cpu")
    _, outs, passes = tcz.prepared_unfused_launch(*torch_args, retry_timeout=8)
    _, fused_outs = tcz.prepared_launch(*torch_args, retry_timeout=8)
    assert [(o.shape, o.dtype) for o in outs] == [
        (o.shape, o.dtype) for o in fused_outs
    ]
    plain = tcz.reference_unfused_passes(*torch_args, retry_timeout=8)
    assert list(passes) == list(plain) == list(tcz.UNFUSED_PASSES)
    for name in tcz.UNFUSED_PASSES:
        assert [(o.shape, o.dtype) for o in passes[name]] == [
            (o.shape, o.dtype) for o in plain[name]
        ], name
    port = tcz.reference_unfused_grid_vote(*torch_args, retry_timeout=8)
    _assert_equal(jcz.reference_grid_vote(*_jax_args(args), retry_timeout=8), port)


def test_unfused_wrapper_rejects_bad_inputs():
    args = list(registry.to_torch(_args((2, 2, 3, 4, 8)), "cpu"))
    args[9] = args[9].to(torch.int8)  # p2b_del must be bool
    with pytest.raises(TypeError, match="compartmentalized_unfused_grid_vote"):
        tcz.prepared_unfused_launch(*args, retry_timeout=8)
    args = list(registry.to_torch(_args((2, 2, 3, 4, 8)), "cpu"))
    args[3] = args[3].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        tcz.unfused_grid_vote(*args, retry_timeout=8)


def test_unfused_counter_is_not_a_plane():
    """As in JAX, nothing dispatches the six-pass twin: it has a launch
    count of its own but no registered plane."""
    assert tcz.UNFUSED_PLANE in registry.LAUNCHES
    assert tcz.UNFUSED_PLANE not in registry.PLANES
    assert tcz.UNFUSED_PASSES == (
        "age", "vote", "counts", "choose", "replica", "retry",
    )


def _grid_tensors(R, C, NR, G, W):
    """Zero tensors of the grid-vote plane's shapes and dtypes, t last."""
    shapes = {
        "rcgw": (R, C, G, W), "ngw": (NR, G, W), "ng": (NR, G),
        "gw": (G, W), "g": (G,),
    }
    return tuple(
        torch.zeros(shapes[kind], dtype=dtype)
        for kind, dtype in (tcz._IN_SPECS[s] for s in tcz.GRID_VOTE_IN_SLOTS)
    ) + (33,)


@pytest.mark.parametrize("shape,skew,route", [
    ((2, 2, 3, 25000, 32), None, "vector"),  # the main shape, aligned
    ((2, 2, 3, 25000, 32), 0, "scalar"),  # p2a one element off
    ((2, 2, 3, 25000, 32), 3, "scalar"),  # status one byte off
    ((2, 2, 3, 25000, 32), 13, "scalar"),  # rep_lat one element off
    ((2, 2, 3, 40, 12), None, "scalar"),  # W % 8 != 0
    ((2, 2, 3, 7, 16), None, "vector"),  # G = 7
    ((2, 2, 3, 4, 1024), None, "vector"),
    ((1, 4, 4, 7, 16), None, "vector"),  # four cells, four replicas
    ((2, 3, 2, 7, 16), None, "scalar"),  # six cells: more than a thread holds
    ((2, 2, 5, 7, 16), None, "scalar"),  # five replicas
    ((2, 2, 3, 2, 2048), None, "general"),  # W > 1024
    ((2, 2, 3, 2, 2048), 0, "general"),
])
def test_grid_vote_route(shape, skew, route):
    """The route the wrapper asks the kernel for, from W and the planes'
    16-byte alignment; prepared_launch on CPU tensors takes it."""
    args = list(_grid_tensors(*shape))
    if skew is not None:
        flat = torch.empty(args[skew].numel() + 1, dtype=args[skew].dtype)
        args[skew] = flat[1:].view(args[skew].shape)
        assert args[skew].is_contiguous() and args[skew].data_ptr() % 16
    assert tcz.grid_vote_route(*args) == route
    launch, _ = tcz.prepared_launch(*args, retry_timeout=8)
    assert launch.route == route


@pytest.mark.parametrize("shape,skew,flat,replica", [
    ((2, 2, 3, 25000, 32), None, "vector", "vector"),  # the main shape
    ((2, 2, 3, 25000, 32), 0, "scalar", "scalar"),  # p2a one element off
    ((2, 2, 3, 25000, 32), 3, "scalar", "scalar"),  # status one byte off
    ((2, 2, 3, 25000, 32), 13, "scalar", "scalar"),  # rep_lat one element off
    ((2, 3, 2, 7, 16), None, "vector", "vector"),  # six cells: two trips of rows
    ((3, 2, 3, 64, 64), None, "vector", "vector"),
    ((2, 2, 5, 9, 24), None, "vector", "vector"),  # W / 8 = 3: no shuffle
    ((2, 3, 2, 7, 12), None, "scalar", "scalar"),  # G * W % 8 != 0
    ((2, 2, 3, 2000, 12), None, "vector", "scalar"),  # W % 8 != 0
    ((2, 2, 3, 4, 1024), None, "vector", "vector"),
    ((2, 2, 3, 2, 2048), None, "vector", "general"),  # W > 1024
    ((2, 2, 3, 2, 2048), 0, "scalar", "general"),
    ((2, 3, 2, 1, 1030), None, "scalar", "general"),
])
def test_unfused_routes(shape, skew, flat, replica):
    """Each pass's route, from G * W, W and the planes' 16-byte alignment;
    prepared_unfused_launch on CPU tensors takes them and packs the eight
    integers of a build without routes, then the two route codes (the
    replica pass's groups per CTA for its route)."""
    args = list(_grid_tensors(*shape))
    if skew is not None:
        flat_buf = torch.empty(args[skew].numel() + 1, dtype=args[skew].dtype)
        args[skew] = flat_buf[1:].view(args[skew].shape)
    routes = tcz.unfused_routes(*args)
    assert routes == {name: replica if name == "replica" else flat
                      for name in tcz.UNFUSED_PASSES}
    launch, _, _ = tcz.prepared_unfused_launch(*args, retry_timeout=8)
    assert launch.routes == routes
    assert launch.route == (flat if flat == replica else f"{flat}+{replica}")
    assert set(launch.passes) == set(tcz.UNFUSED_PASSES)
    R, C, NR, G, W = shape
    ints = list(launch.packed[1])
    assert ints[:7] == [R, C, NR, G, W, 33, 8]
    assert ints[7] == tcz._groups_per_cta(replica, W, 0)
    assert ints[8:] == [registry.ROUTES.index(flat), registry.ROUTES.index(replica)]
    if replica == "vector":
        assert W // 8 * ints[7] <= 256


@pytest.mark.parametrize("shape", UNFUSED_SHAPES + [(2, 2, 3, 25, 32)])
def test_unfused_needed_bytes(shape):
    """Each pass's needed bytes: what it reads and writes, less the masks
    and latencies it skips, counted here cell by cell from the plain
    passes."""
    args = registry.to_torch(_args(shape), "cpu")
    got = tcz.unfused_needed_bytes(*args, retry_timeout=8)
    R, C, NR, G, W = shape
    plain = tcz.reference_unfused_passes(*args, retry_timeout=8)
    p2a, p2b_del, retry_del = plain["age"][0], args[9], args[10]
    voted = p2a == 0
    delivered = voted & p2b_del
    timed = plain["retry"][2]
    cells, slots = R * C * G * W, G * W
    # age: three int16 planes in, three out.
    assert got["age"] == 2 * 2 * (2 * cells + NR * slots)
    # vote: two aged planes and o_p2b (2 B a cell), p2b_del where voting,
    # p2b_lat where delivered.
    assert got["vote"] == 6 * cells + int(voted.sum()) + 4 * int(delivered.sum())
    assert got["counts"] == 2 * cells + int(voted.sum()) + 8 * slots
    replica = got["replica"]
    armed = int(plain["choose"][1].sum()) * NR
    assert replica == (4 * NR * slots + 2 * slots + 4 * NR * G * 2 + 8 * G
                       + 4 * armed)
    resent = int((timed[None, None] & retry_del).sum())
    due = (plain["choose"][0] == tcz.PROPOSED) & ((33 - args[4]) >= 8)
    assert got["retry"] == (4 * cells + 1 * slots + 4 * slots + int(due.sum())
                            + int(timed.sum()) * R * C + 4 * resent
                            + 4 * slots + slots)
    assert 0 < got["choose"] <= 2 * cells + 3 * slots + 2 * slots
