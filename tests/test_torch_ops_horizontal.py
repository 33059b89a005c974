"""The port's Horizontal MultiPaxos vote plane (the plain PyTorch version,
which the CUDA kernel is held against on the card) against the JAX
package's ``reference_horizontal_vote`` and its Pallas
``fused_horizontal_vote`` in interpret mode: the same numpy inputs, all
eight outputs equal, dtypes included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import horizontal as jhz
from frankenpaxos_tpu_torch.ops import horizontal as thz
from frankenpaxos_tpu_torch.ops import registry

SHAPES = [(6, 5, 16), (10, 3, 8)]  # P, G, W (f=1 with a ragged G, f=2)
CASES = list(thz.EDGE_CASES)

_DT = {
    np.dtype("int8"): torch.int8,
    np.dtype("int16"): torch.int16,
    np.dtype("int32"): torch.int32,
    np.dtype("bool"): torch.bool,
}


def _statics(shape):
    n = shape[0] // 2
    return dict(n=n, quorum=(n - 1) // 2 + 1)


def _args(shape, case="random"):
    return thz.example_horizontal_vote_args(
        np.random.default_rng(sum(shape)), *shape, case=case
    )


def _jax_args(args):
    return tuple(
        jnp.asarray(a) if isinstance(a, np.ndarray) else jnp.int32(a)
        for a in args
    )


def _assert_equal(jax_outs, port_outs):
    assert len(jax_outs) == len(port_outs) == len(thz.HORIZONTAL_VOTE_OUTS)
    for name, j, p in zip(thz.HORIZONTAL_VOTE_OUTS, jax_outs, port_outs):
        j = np.asarray(j)
        assert _DT[j.dtype] == p.dtype, f"{name}: {j.dtype} vs {p.dtype}"
        assert tuple(j.shape) == tuple(p.shape), name
        np.testing.assert_array_equal(j, p.numpy(), err_msg=name)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_reference(shape, case):
    args = _args(shape, case)
    port = thz.reference_horizontal_vote(
        *registry.to_torch(args, "cpu"), **_statics(shape)
    )
    _assert_equal(
        jhz.reference_horizontal_vote(*_jax_args(args), **_statics(shape)), port
    )


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_interpret_kernel(shape, case):
    args = _args(shape, case)
    port = thz.reference_horizontal_vote(
        *registry.to_torch(args, "cpu"), **_statics(shape)
    )
    kern = jhz.fused_horizontal_vote(
        *_jax_args(args), block=2, interpret=True, **_statics(shape)
    )
    _assert_equal(kern, port)


@pytest.mark.parametrize("shape", SHAPES)
def test_no_delivery_plane_means_all_delivered(shape):
    """``p2b_delivered=None`` (the healthy tick, where the kernel reads no
    delivery plane) equals an all-ones plane, as the JAX tick passes."""
    args = list(_args(shape, "all_now"))
    args[8] = np.ones_like(args[8])
    want = jhz.reference_horizontal_vote(*_jax_args(args), **_statics(shape))
    args[8] = None
    got = thz.reference_horizontal_vote(
        *registry.to_torch(args, "cpu"), **_statics(shape)
    )
    _assert_equal(want, got)


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_on_cpu_is_the_plain_version(shape):
    registry.reset_launches()
    for deliv in (True, False):
        args = list(registry.to_torch(_args(shape), "cpu"))
        if not deliv:
            args[8] = None
        got = thz.fused_horizontal_vote(*args, **_statics(shape))
        want = thz.reference_horizontal_vote(*args, **_statics(shape))
        for name, g, w in zip(thz.HORIZONTAL_VOTE_OUTS, got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), name
    assert registry.LAUNCHES["horizontal_vote"] == 0


def test_example_inputs_reach_every_branch():
    """The random inputs vote in both banks, schedule and drop replies and
    choose; the edge cases do what they say."""
    shape = (6, 64, 16)
    st = _statics(shape)
    se, status, pt, p2a, p2b, voted, ve, lat, deliv, t = registry.to_torch(
        _args(shape), "cpu"
    )
    out = thz.reference_horizontal_vote(
        se, status, pt, p2a, p2b, voted, ve, lat, deliv, t, **st
    )
    new_voted, newly, viol = out[3], out[5], out[7]
    landed = new_voted & ~voted
    assert bool(landed[:3].any()) and bool(landed[3:].any())
    assert bool((landed & deliv & (out[2] != p2b)).any())
    assert bool((landed & ~deliv).any())
    assert bool(newly.any()) and int(viol.max()) > 0
    assert bool(((se == -1) & (status == thz.PROPOSED)).any())

    def run(case):
        return thz.reference_horizontal_vote(
            *registry.to_torch(_args(shape, case), "cpu"), **st
        )

    assert int(run("no_epoch")[7].sum()) == 0
    now = run("all_now")
    assert bool(now[3].any()) and not bool((now[1] == 40).any())
    assert int(run("forged")[7].sum()) > 0
    never = run("all_inf")
    assert not bool(never[3].any()) and not bool(never[5].any())
    dropped = registry.to_torch(_args(shape, "dropped"), "cpu")
    out = thz.reference_horizontal_vote(*dropped, **st)
    assert torch.equal(out[2], dropped[4])  # no reply scheduled


def test_slot_codes_and_registration():
    from frankenpaxos_tpu.tpu import horizontal_batched as jhb

    assert (thz.EMPTY, thz.PROPOSED, thz.CHOSEN, thz.NO_VALUE) == (
        jhz.EMPTY, jhz.PROPOSED, jhz.CHOSEN, jhz.NO_VALUE,
    ) == (jhb.EMPTY, jhb.PROPOSED, jhb.CHOSEN, jhb.NO_VALUE)
    plane = registry.PLANES["horizontal_vote"]
    assert plane.backend == "horizontal"
    assert plane.source == "frankenpaxos_tpu_torch/csrc/horizontal.cu"
    assert plane.replaces.startswith(
        "frankenpaxos_tpu/ops/horizontal.py:154 fused_horizontal_vote"
    )


def test_wrapper_rejects_mixed_devices():
    args = list(registry.to_torch(_args((6, 4, 8)), "cpu"))
    args[4] = args[4].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        thz.fused_horizontal_vote(*args, n=3, quorum=2)


@pytest.mark.parametrize("shape", [(18, 3, 16), (22, 2, 8)])
def test_kernel_checks_accept_f_over_3(shape):
    """The wrapper's checks take banks of n = 9 and 11 (f = 4, 5; the
    general instantiation on the card); the plain version there equals
    the JAX reference."""
    args = _args(shape)
    st = _statics(shape)
    torch_args = registry.to_torch(args, "cpu")
    _, outs = thz.prepared_launch(*torch_args, **st)
    port = thz.reference_horizontal_vote(*torch_args, **st)
    assert [(o.shape, o.dtype) for o in outs] == [(p.shape, p.dtype) for p in port]
    _assert_equal(jhz.reference_horizontal_vote(*_jax_args(args), **st), port)
    with pytest.raises(ValueError, match="P = 2n"):
        thz.prepared_launch(*torch_args, n=st["n"] + 1, quorum=st["quorum"])


def _zeros(P, G, W):
    """Zero tensors of the plane's shapes and dtypes (``t`` last)."""
    z = torch.zeros
    pgw = (P, G, W)
    return [
        z((G, W), dtype=torch.int16), z((G, W), dtype=torch.int8),
        z((G, W), dtype=torch.int32), z(pgw, dtype=torch.int32),
        z(pgw, dtype=torch.int32), z(pgw, dtype=torch.bool),
        z(pgw, dtype=torch.int16), z(pgw, dtype=torch.int32),
        z(pgw, dtype=torch.bool), 40,
    ]


def _odd_offset(x):
    """A contiguous view of x's values one element past its own base."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)
    return flat[1:].view(x.shape).copy_(x)


@pytest.mark.parametrize("shape,skew,deliv,block,route", [
    ((6, 3334, 32), None, False, 0, "vector"),  # the main path
    ((6, 3334, 32), None, True, 0, "vector"),  # under a fault plan
    ((6, 33334, 32), None, False, 0, "vector"),  # 100,002 acceptors
    ((6, 40, 12), None, True, 0, "vector"),  # W = 12
    ((6, 40, 8), None, False, 0, "vector"),  # W = 8
    ((18, 9, 8), None, True, 0, "vector"),  # n = 9, the general n
    ((6, 40, 6), None, True, 0, "general"),  # W % 4 != 0
    ((6, 3334, 32), 3, True, 0, "general"),  # Phase2a one element off
    ((6, 3334, 32), 5, False, 0, "general"),  # a byte plane one element off
    ((6, 3334, 32), 8, True, 0, "general"),  # the delivery plane off
    ((6, 3334, 32), None, False, 512, "general"),  # a block past 256
    ((6, 3334, 32), None, False, 96, "vector"),  # three warps
    ((6, 3334, 32), None, False, 100, "general"),  # a block of part warps
])
def test_horizontal_vote_route(shape, skew, deliv, block, route):
    """The route the wrapper asks the kernel for, from W, the block and
    the planes' 16-byte alignment; prepared_launch on CPU tensors takes
    it and packs its code and threads."""
    args = _zeros(*shape)
    if not deliv:
        args[8] = None
    if skew is not None:
        args[skew] = _odd_offset(args[skew])
        assert args[skew].is_contiguous() and args[skew].data_ptr() % 16
    assert thz.horizontal_vote_route(*args, block=block) == route
    launch, _ = thz.prepared_launch(*args, block, **_statics(shape))
    assert launch.route == route
    ints = list(launch.packed[1])
    assert ints[6] == registry.ROUTES.index(route)
    assert ints[5] == (block or (thz.VEC_THREADS if route == "vector" else 256))


def test_horizontal_vote_needed_bytes_counted_by_hand():
    """n = 1 (P = 2), G = 1, W = 2, quorum 1. Slot 0 (epoch 0, bank 0) gets
    a vote in row 0 whose reply lands now (latency 0), so it is newly
    chosen; slot 1 (epoch 1, bank 1) gets a vote in row 1 whose reply is
    dropped; the other two cells carry their vote."""
    args = _zeros(2, 1, 2)
    args[0][:] = torch.tensor([[0, 1]], dtype=torch.int16)
    args[1][:] = thz.PROPOSED
    args[2][:] = torch.tensor([[35, 36]], dtype=torch.int32)
    args[3][:] = torch.tensor([[[40, 40]], [[thz.INF, 40]]], dtype=torch.int32)
    args[4][:] = thz.INF
    args[7][:] = torch.tensor([[[0, 1]], [[1, 1]]], dtype=torch.int32)
    args[8][:] = torch.tensor([[[True, True]], [[True, False]]])
    st = dict(n=1, quorum=1)
    out = thz.reference_horizontal_vote(*args, **st)
    assert out[5].tolist() == [[True, False]]
    cells = (
        4 * 4  # Phase2a ticks in
        + 2 * (1 + 2 + 4)  # two cells carry vote, vote epoch, Phase2b
        + 2  # the delivery bits of the two votes
        + 4  # the sent reply's latency
        + 4  # the dropped reply's carried Phase2b tick
        + 4 * (4 + 4 + 1 + 2)  # Phase2a, Phase2b, vote, vote epoch out
    )
    slots = 2 * (2 + 1) + 4 + 2 * (1 + 1 + 4 + 4)  # in, proposal tick, out
    assert thz.horizontal_vote_needed_bytes(args, **st) == cells + slots == 114
    args[8] = None  # every reply sent: two latencies, no delivery bits
    assert thz.horizontal_vote_needed_bytes(args, **st) == 114 - 2 == 112
