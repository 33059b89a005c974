"""The port's MultiPaxos tick planes (plain PyTorch versions, which the
CUDA kernels are held against on the card) against the JAX package's
``reference_*`` twins and its Pallas kernels in interpret mode: the
same numpy inputs, every output equal, dtypes included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import multipaxos as jmp
from frankenpaxos_tpu_torch.ops import multipaxos as tmp
from frankenpaxos_tpu_torch.ops import registry
from frankenpaxos_tpu_torch.tpu.common import age_clock

SHAPES = [(3, 8, 16), (5, 6, 32), (3, 7, 64)]

_DT = {
    np.dtype("int8"): torch.int8,
    np.dtype("int16"): torch.int16,
    np.dtype("int32"): torch.int32,
    np.dtype("bool"): torch.bool,
}


def _jax_args(args):
    return tuple(
        jnp.asarray(a) if isinstance(a, np.ndarray) else jnp.int32(a)
        for a in args
    )


def _assert_equal(jax_outs, port_outs, names):
    assert len(jax_outs) == len(port_outs) == len(names)
    for name, j, p in zip(names, jax_outs, port_outs):
        j = np.asarray(j)
        assert _DT[j.dtype] == p.dtype, f"{name}: {j.dtype} vs {p.dtype}"
        assert tuple(j.shape) == tuple(p.shape), name
        np.testing.assert_array_equal(j, p.numpy(), err_msg=name)


def _statics(A, G):
    return dict(f=(A - 1) // 2, retry_timeout=8, num_groups=G)


@pytest.mark.parametrize("shape", SHAPES)
def test_vote_quorum(shape):
    A, G, W = shape
    args = tmp.example_vote_quorum_args(np.random.default_rng(A * G), A, G, W)
    port = tmp.fused_vote_quorum(*tmp.to_torch(args, "cpu"))
    ref = jmp.reference_vote_quorum(*_jax_args(args))
    _assert_equal(ref, port, tmp.VOTE_QUORUM_OUTS)
    kern = jmp.fused_vote_quorum(
        *_jax_args(args), block=max(G // 2, 1), interpret=True
    )
    _assert_equal(kern, port, tmp.VOTE_QUORUM_OUTS)


@pytest.mark.parametrize("shape", SHAPES)
def test_mp_dispatch(shape):
    A, G, W = shape
    args = tmp.example_mp_dispatch_args(np.random.default_rng(W), A, G, W)
    st = _statics(A, G)
    port = tmp.fused_mp_dispatch(*tmp.to_torch(args, "cpu"), **st)
    ref = jmp.reference_mp_dispatch(*_jax_args(args), **st)
    _assert_equal(ref, port, tmp.MP_DISPATCH_OUTS)
    kern = jmp.fused_mp_dispatch(
        *_jax_args(args), block=max(G // 2, 1), interpret=True, **st
    )
    _assert_equal(kern, port, tmp.MP_DISPATCH_OUTS)


@pytest.mark.parametrize("age", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_tick(shape, age):
    A, G, W = shape
    args = tmp.example_fused_tick_args(
        np.random.default_rng(G + W), A, G, W, age=age
    )
    st = dict(_statics(A, G), age=age)
    port = tmp.fused_tick(*tmp.to_torch(args, "cpu"), **st)
    ref = jmp.reference_fused_tick(*_jax_args(args), **st)
    _assert_equal(ref, port, tmp.FUSED_TICK_OUTS)
    kern = jmp.fused_tick(
        *_jax_args(args), block=max(G // 2, 1), interpret=True, **st
    )
    _assert_equal(kern, port, tmp.FUSED_TICK_OUTS)


P1_CASES = [
    (case, shape, seed)
    for shape in [(3, 8, 16), (5, 6, 32)]
    for case, seeds in (("random", (0, 1, 2)), ("noop", (0,)), ("ties", (0,)))
    for seed in seeds
]


@pytest.mark.parametrize("case,shape,seed", P1_CASES)
def test_p1_promise(case, shape, seed):
    A, G, W = shape
    args = tmp.example_p1_promise_args(
        np.random.default_rng(seed), A, G, W, case=case
    )
    port = tmp.fused_p1_promise(*tmp.to_torch(args, "cpu"))
    ref = jmp.reference_p1_promise(*_jax_args(args))
    _assert_equal(ref, port, tmp.P1_PROMISE_OUTS)
    kern = jmp.fused_p1_promise(
        *_jax_args(args), block=max(G // 2, 1), interpret=True
    )
    _assert_equal(kern, port, tmp.P1_PROMISE_OUTS)


def test_p1_promise_edge_cases_bite():
    """The edge inputs do what they are for: "noop" repairs every slot
    to a noop, and "ties" picks the first learned acceptor's value."""
    A, G, W = 3, 4, 16
    args = tmp.to_torch(
        tmp.example_p1_promise_args(np.random.default_rng(1), A, G, W, "noop"),
        "cpu",
    )
    sv, _, p2b, ls = tmp.reference_p1_promise(*args)
    assert (sv == tmp.NOOP_VALUE).all() and (ls == args[-1]).all()
    assert (p2b == tmp.INF16).all()
    args = tmp.to_torch(
        tmp.example_p1_promise_args(np.random.default_rng(2), A, G, W, "ties"),
        "cpu",
    )
    status, vr, vv, _, _, _, _, _, learned, _, _ = args
    sv = tmp.reference_p1_promise(*args)[0]
    first = torch.argmax(learned.to(torch.int32), dim=0)  # [G]
    want = torch.gather(vv, 0, first[None, :, None].expand(1, G, W))[0]
    any_learned = learned.any(dim=0)[:, None] & (vr[0] >= 0)
    want = torch.where(any_learned, want, tmp.NOOP_VALUE)
    assert torch.equal(sv, want)
    # The tie is real: the acceptors' values differ somewhere.
    assert bool((vv[0] != vv[1]).any())


def test_fused_tick_is_age_then_vote_then_dispatch():
    """In the port too, the whole-tick plane IS aging, then the vote
    plane, then the dispatch plane."""
    A, G, W = 3, 6, 16
    args = tmp.to_torch(
        tmp.example_fused_tick_args(np.random.default_rng(9), A, G, W), "cpu"
    )
    (p2a, acc_round, leader_round, slot_value, vote_round, vote_value,
     p2b, p2b_lat, delivered, head,
     status, propose_tick, last_send, chosen_tick, chosen_round,
     chosen_value, replica_arrival, next_slot, cap, retry_ok,
     send_ok, retry_deliv, p2a_lat, retry_lat, rep_lat, group_ids, t) = args
    st = _statics(A, G)
    fused = tmp.reference_fused_tick(*args, age=True, **st)
    p2a_aged, p2b_aged = age_clock(p2a), age_clock(p2b)
    vr, vv, p2b2, accr, nvotes, nsends, max_ord = tmp.reference_vote_quorum(
        p2a_aged, acc_round, leader_round, slot_value, vote_round,
        vote_value, p2b_aged, p2b_lat, delivered, head,
    )
    planes = tmp.reference_mp_dispatch(
        status, slot_value, propose_tick, last_send, chosen_tick,
        chosen_round, chosen_value, replica_arrival, p2a_aged, p2b2,
        vr, vv, nvotes, head, next_slot, leader_round, cap, retry_ok,
        send_ok, retry_deliv, p2a_lat, retry_lat, rep_lat, group_ids, t,
        **st,
    )
    for name, x, y in zip(
        tmp.FUSED_TICK_OUTS, (*planes, accr, nsends, max_ord), fused
    ):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_cpu_calls_never_count_as_launches():
    registry.reset_launches()
    A, G, W = 3, 4, 16
    args = tmp.to_torch(
        tmp.example_fused_tick_args(np.random.default_rng(0), A, G, W), "cpu"
    )
    tmp.fused_tick(*args, **_statics(A, G))
    assert all(n == 0 for n in registry.LAUNCHES.values())
    tmp.fused_p1_promise(*tmp.to_torch(
        tmp.example_p1_promise_args(np.random.default_rng(0), A, G, W), "cpu"
    ))
    assert all(n == 0 for n in registry.LAUNCHES.values())
    assert set(registry.LAUNCHES) == {
        "multipaxos_fused_tick", "multipaxos_vote_quorum",
        "multipaxos_dispatch", "multipaxos_p1_promise",
        "compartmentalized_grid_vote", "mencius_vote", "fastmultipaxos_vote",
        "horizontal_vote", "scalog_cut_commit", "craq_chain",
        "depgraph_execute", "compartmentalized_unfused_grid_vote",
    }


def test_mixed_devices_raise():
    args = list(
        tmp.to_torch(
            tmp.example_vote_quorum_args(np.random.default_rng(0), 3, 4, 16),
            "cpu",
        )
    )
    args[3] = args[3].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        tmp.fused_vote_quorum(*args)


# Shapes the JAX kernels run and the card kernels once refused: f=5
# (A=11), W > 1024, and both at once at a ragged W.
REPAIRED = [(11, 3, 16), (3, 1, 2048), (13, 2, 1030)]
_EXAMPLES = {  # plane: (example inputs, statics)
    "multipaxos_vote_quorum": (tmp.example_vote_quorum_args, {}),
    "multipaxos_dispatch": (tmp.example_mp_dispatch_args, dict(f=1)),
    "multipaxos_fused_tick": (tmp.example_fused_tick_args, dict(age=True)),
    "multipaxos_p1_promise": (tmp.example_p1_promise_args, {}),
}


@pytest.mark.parametrize("shape", REPAIRED)
@pytest.mark.parametrize("plane", sorted(_EXAMPLES))
def test_kernel_checks_accept_the_shapes_jax_runs(plane, shape):
    """The wrapper's checks (everything before the CUDA library loads)
    take f >= 5 and W > 1024; its outputs are the plain version's shapes
    and dtypes."""
    A, G, W = shape
    make, statics = _EXAMPLES[plane]
    args = tmp.to_torch(make(np.random.default_rng(A + W), A, G, W), "cpu")
    st = dict(_statics(A, G), **statics) if statics else {}
    _, outs = tmp.prepared_launch(plane, *args, **st)
    want = registry.PLANES[plane].reference(*args, **st)
    assert [(o.shape, o.dtype) for o in outs] == [
        (w.shape, w.dtype) for w in want
    ]


@pytest.mark.parametrize("shape", REPAIRED[:2])
def test_fused_tick_at_repaired_shapes_matches_jax(shape):
    A, G, W = shape
    args = tmp.example_fused_tick_args(np.random.default_rng(W), A, G, W)
    st = dict(_statics(A, G), age=True)
    port = tmp.fused_tick(*tmp.to_torch(args, "cpu"), **st)
    _assert_equal(
        jmp.reference_fused_tick(*_jax_args(args), **st), port,
        tmp.FUSED_TICK_OUTS,
    )


def test_kernel_checks_keep_their_memory_guards():
    args = list(tmp.to_torch(
        tmp.example_vote_quorum_args(np.random.default_rng(0), 11, 2, 16), "cpu"
    ))
    bad = list(args)
    bad[0] = bad[0].to(torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        tmp.prepared_launch("multipaxos_vote_quorum", *bad)
    bad = list(args)
    bad[4] = bad[4].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tmp.prepared_launch("multipaxos_vote_quorum", *bad)
