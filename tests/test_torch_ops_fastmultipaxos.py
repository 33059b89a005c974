"""The port's Fast MultiPaxos vote plane (the plain PyTorch version,
which the CUDA kernel is held against on the card) against the JAX
package's ``reference_fmp_vote`` and its Pallas ``fused_fmp_vote`` in
interpret mode: the same numpy inputs, all thirteen outputs equal, dtypes
included, on random inputs and on the edge inputs (no visible vote, an
all-distinct census, ties, a slot exactly at the recovery timeout, a
fast-committed value contradicted)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import fastmultipaxos as jfo
from frankenpaxos_tpu.tpu import fastmultipaxos_batched as jfb
from frankenpaxos_tpu_torch.ops import fastmultipaxos as tfo
from frankenpaxos_tpu_torch.ops import registry
from frankenpaxos_tpu_torch.tpu import fastmultipaxos_batched as tfb

SHAPES = [(3, 7, 16), (5, 4, 32), (3, 5, 8)]  # A, G, W (ragged, f=2, small)
RT = 10  # recovery_timeout

_DT = {
    np.dtype("int8"): torch.int8,
    np.dtype("int32"): torch.int32,
    np.dtype("bool"): torch.bool,
}


def _statics(A):
    f = (A - 1) // 2
    return dict(fq=f + (f + 1) // 2 + 1, f=f, recovery_timeout=RT)


def _args(shape, case="random"):
    return tfo.example_fmp_vote_args(
        np.random.default_rng(sum(shape)), *shape, case=case,
        recovery_timeout=RT,
    )


def _jax_args(args):
    return tuple(
        jnp.asarray(a) if isinstance(a, np.ndarray) else jnp.int32(a)
        for a in args
    )


def _port(args):
    return tfo.reference_fmp_vote(
        *registry.to_torch(args, "cpu"), **_statics(args[0].shape[0])
    )


def _assert_equal(jax_outs, port_outs):
    assert len(jax_outs) == len(port_outs) == len(tfo.FMP_VOTE_OUTS)
    for name, j, p in zip(tfo.FMP_VOTE_OUTS, jax_outs, port_outs):
        j = np.asarray(j)
        assert _DT[j.dtype] == p.dtype, f"{name}: {j.dtype} vs {p.dtype}"
        assert tuple(j.shape) == tuple(p.shape), name
        np.testing.assert_array_equal(j, p.numpy(), err_msg=name)


@pytest.mark.parametrize("case", tfo.EDGE_CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_reference(shape, case):
    args = _args(shape, case)
    ref = jfo.reference_fmp_vote(*_jax_args(args), **_statics(shape[0]))
    _assert_equal(ref, _port(args))


@pytest.mark.parametrize("case", tfo.EDGE_CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_interpret_kernel(shape, case):
    args = _args(shape, case)
    kern = jfo.fused_fmp_vote(
        *_jax_args(args), block=max(shape[1] // 2, 1), interpret=True,
        **_statics(shape[0]),
    )
    _assert_equal(kern, _port(args))


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_on_cpu_is_the_plain_version(shape):
    registry.reset_launches()
    args = registry.to_torch(_args(shape), "cpu")
    got = tfo.fused_fmp_vote(*args, **_statics(shape[0]))
    want = tfo.reference_fmp_vote(*args, **_statics(shape[0]))
    for name, g, w in zip(tfo.FMP_VOTE_OUTS, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert registry.LAUNCHES["fastmultipaxos_vote"] == 0


def _outs(shape, case):
    return dict(zip(tfo.FMP_VOTE_OUTS, _port(_args(shape, case))))


def test_edge_inputs_do_what_they_say():
    shape = (3, 64, 32)
    out = _outs(shape, "random")
    for mask in ("newly_chosen", "fast_ok", "start_rec"):
        assert bool(out[mask].any()), mask
    # No visible vote: no fast choose, no recovery, no slot opens.
    args = _args(shape, "no_visible")
    out = _outs(shape, "no_visible")
    assert not bool((out["fast_ok"] | out["start_rec"]).any())
    assert torch.equal(out["open_tick"], torch.from_numpy(args[3]))
    # A full census of distinct values recovers with acceptor 0's value.
    args = _args(shape, "all_distinct")
    out = _outs(shape, "all_distinct")
    assert bool(out["start_rec"].all())
    assert torch.equal(out["rv_value"], torch.from_numpy(args[0][0]))
    # Two values tied: the first maximum (acceptor 0's value) wins.
    out = _outs(shape, "ties")
    assert bool((out["rv_value"] == 5).all())
    # Exactly at the timeout recovers, one tick short does not.
    args = _args(shape, "at_timeout")
    out = _outs(shape, "at_timeout")
    at = torch.from_numpy(args[3]) == args[-1] - RT
    assert bool(at.any()) and bool((~at).any())
    assert torch.equal(out["start_rec"], at)
    # A choice against the ledger is flagged.
    out = _outs(shape, "contradicted")
    assert bool(out["safety"].any()) and bool(out["fast_ok"].any())


def test_slot_codes_mirror_the_backend():
    codes = (tfo.S_OPEN, tfo.S_RECOVER, tfo.S_CHOSEN, tfo.NO_VALUE)
    assert codes == (jfo.S_OPEN, jfo.S_RECOVER, jfo.S_CHOSEN, jfo.NO_VALUE)
    assert codes == (tfb.S_OPEN, tfb.S_RECOVER, tfb.S_CHOSEN, tfb.NO_VALUE)
    assert codes == (jfb.S_OPEN, jfb.S_RECOVER, jfb.S_CHOSEN, jfb.NO_VALUE)


def test_registration():
    plane = registry.PLANES["fastmultipaxos_vote"]
    assert plane.backend == "fastmultipaxos"
    assert plane.source == "frankenpaxos_tpu_torch/csrc/fastmultipaxos.cu"
    assert plane.replaces.startswith(
        "frankenpaxos_tpu/ops/fastmultipaxos.py:266 fused_fmp_vote"
    )


def test_wrapper_rejects_mixed_devices():
    args = list(registry.to_torch(_args((3, 4, 8)), "cpu"))
    args[4] = args[4].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        tfo.fused_fmp_vote(*args, **_statics(3))


@pytest.mark.parametrize("shape", [(11, 3, 16), (13, 2, 8)])
def test_kernel_checks_accept_f_over_4(shape):
    """The wrapper's checks take A = 2f+1 >= 11 and send it to the general
    route (its instantiation with A at run time on the card); the plain
    version there equals the JAX reference."""
    args = _args(shape)
    st = _statics(shape[0])
    launch, outs = tfo.prepared_launch(*registry.to_torch(args, "cpu"), **st)
    assert launch.route == "general"  # A at run time on the card
    assert list(launch.packed[1])[0] == shape[0]
    port = _port(args)
    assert [(o.shape, o.dtype) for o in outs] == [(p.shape, p.dtype) for p in port]
    _assert_equal(jfo.reference_fmp_vote(*_jax_args(args), **st), port)


def _zeros(A, G, W):
    """Zero tensors of the plane's shapes and dtypes (``t`` = 40 last)."""
    agw, gw = (A, G, W), (G, W)
    i32 = dict(dtype=torch.int32)
    return [
        torch.zeros(agw, **i32), torch.zeros(agw, **i32),
        torch.zeros(gw, dtype=torch.int8), torch.zeros(gw, **i32),
        torch.zeros(gw, **i32), torch.zeros(gw, **i32),
        torch.zeros(agw, **i32), torch.zeros(agw, **i32),
        torch.zeros(agw, dtype=torch.bool), torch.zeros(gw, **i32),
        torch.zeros(gw, **i32), torch.zeros(gw, **i32),
        torch.zeros(gw, **i32), 40,
    ]


@pytest.mark.parametrize("shape,skew,block,route,threads", [
    ((3, 3334, 32), None, 0, "scalar", 128),  # the main path
    ((3, 33334, 32), None, 0, "scalar", 128),  # 100,002 acceptors
    ((5, 64, 32), None, 0, "scalar", 128),  # f = 2
    ((9, 16, 16), None, 0, "scalar", 128),  # f = 4, the largest templated A
    ((3, 7, 6), None, 0, "scalar", 128),  # W % 4 != 0
    ((3, 5, 7), None, 0, "scalar", 128),  # G * W % 4 != 0
    ((11, 20, 32), None, 0, "general", 256),  # A = 11 (f = 5)
    ((13, 2, 8), None, 0, "general", 256),  # A = 13
    ((3, 3334, 32), 0, 0, "scalar", 128),  # the votes one element off
    ((3, 3334, 32), 2, 0, "scalar", 128),  # the status plane one element off
    ((3, 3334, 32), None, 96, "scalar", 96),  # three warps
    ((3, 3334, 32), None, 100, "scalar", 96),  # a block of part warps
    ((3, 3334, 32), None, 512, "scalar", 256),  # a block past 256
    ((11, 20, 32), None, 100, "general", 100),  # the general route's block
])
def test_fmp_vote_route(shape, skew, block, route, threads):
    """The route the wrapper asks the kernel for, from A alone (the scalar
    route moves 4-byte words and bytes, so W and the planes' alignment do
    not matter, and it cuts the block to whole warps up to 256);
    prepared_launch on CPU tensors takes it and packs its code and
    threads."""
    args = _zeros(*shape)
    if skew is not None:
        args[skew] = registry.misaligned([args[skew]])[0]
        assert args[skew].is_contiguous() and args[skew].data_ptr() % 16
    st = _statics(shape[0])
    assert tfo.fmp_vote_route(*args) == route
    launch, outs = tfo.prepared_launch(*args, block, **st)
    assert launch.route == route
    ints = list(launch.packed[1])
    assert ints[:7] == [*shape, 40, st["fq"], st["f"], RT]
    assert ints[7:] == [threads, registry.ROUTES.index(route)]
    assert [tuple(o.shape) for o in outs][4:7] == [shape] * 3


def test_fmp_vote_needed_bytes_counted_by_hand():
    """(A, G, W) = (3, 1, 2) at t = 40 (f = 1, fast quorum 3). Slot 0 has
    three visible votes for 5: a fast choose, so its reply latency is
    needed and its carried chosen value and replica arrival are not. Slot
    1 has three visible distinct votes in an open slot: a full census
    starts recovery, so its classic latency is needed and its three
    classic Phase2a ticks are not; at latency 2 its classic Phase2a
    arrives later and it is not chosen. At latency 0 the Phase2a lands
    now, so its three classic Phase2b ticks and vote bits are not needed;
    all three acceptors vote with replies landing now, and slot 1 is
    chosen too. The scalar route reads every dense field."""
    args = _zeros(3, 1, 2)
    INF = 2**30
    args[0][:] = torch.tensor([[[5, 1]], [[5, 2]], [[5, 3]]], dtype=torch.int32)
    args[1][:] = 39  # every vote seen
    args[3][:] = INF  # no slot open yet
    args[4][:] = tfo.NO_VALUE
    args[6][:] = INF
    args[7][:] = INF
    args[11][:] = 2  # rv_lat
    args[12][:] = 1  # reply_lat
    st = _statics(3)
    out = dict(zip(tfo.FMP_VOTE_OUTS, tfo.reference_fmp_vote(*args, **st)))
    assert out["fast_ok"].tolist() == [[True, False]]
    assert out["start_rec"].tolist() == [[False, True]]
    assert out["newly_chosen"].tolist() == [[True, False]]
    outs = 6 * (4 + 4 + 1) + 2 * (1 + 4 * 5 + 4 * 1)
    dense = 6 * (4 + 4) + 2 * (1 + 4 + 4 + 4)  # votes, seen; slot fields
    needed = (
        dense + 3 * 4  # slot 0's classic Phase2a ticks
        + 6 * (4 + 1)  # every classic Phase2b tick and vote bit
        + 1 * (4 + 4)  # slot 1's chosen value and replica arrival
        + 4 + 4  # slot 1's classic latency, slot 0's reply latency
    )
    assert tfo.fmp_vote_needed_bytes(args, **st) == needed + outs == 236
    route = 6 * (4 + 4 + 4 + 4 + 1) + 2 * (1 + 4 + 4 + 4 + 4 + 4)
    assert tfo.fmp_vote_route_bytes(args, **st) == route + 4 + 4 + outs == 256
    args[11][:] = 0
    out = dict(zip(tfo.FMP_VOTE_OUTS, tfo.reference_fmp_vote(*args, **st)))
    assert out["newly_chosen"].tolist() == [[True, True]]
    # Less slot 1's three Phase2b ticks and vote bits and its chosen
    # stamps; plus its reply latency.
    assert tfo.fmp_vote_needed_bytes(args, **st) == 236 - 3 * 5 - 8 + 4 == 217
    assert tfo.fmp_vote_route_bytes(args, **st) == 256 + 4


@pytest.mark.parametrize("case", tfo.EDGE_CASES)
@pytest.mark.parametrize("shape", SHAPES + [(3, 3334, 32)])
def test_fmp_vote_reads_nothing_outside_the_needed_set(shape, case):
    """Every input cell the needed bytes leave out overwritten with garbage
    from a seeded generator: each classic Phase2a tick where recovery
    starts, each classic Phase2b tick and vote bit where a classic Phase2a
    lands now, each carried chosen value and replica arrival where the
    slot is chosen now, each classic latency where neither recovery starts
    nor a classic Phase2a lands, each reply latency where the slot is not
    chosen now. The plain version's outputs do not change, so a kernel
    may leave those cells unread. The needed bytes count exactly the cells
    kept, and the scalar route's bytes every dense cell."""
    args = _args(shape, case)
    st = _statics(shape[0])
    t = args[-1]
    out = dict(zip(tfo.FMP_VOTE_OUTS, _port(args)))
    start = out["start_rec"].numpy()
    newly = out["newly_chosen"].numpy()
    now = np.where(start[None], (args[11] == 0)[None], args[6] == t)
    rv_needed = start | now.any(axis=0)
    rng = np.random.default_rng(99)

    def garbage(keep, x):
        noise = (rng.random(x.shape) < 0.5 if x.dtype == bool else
                 rng.integers(-(2**31), 2**31, x.shape, dtype=np.int64))
        return np.where(keep, x, noise).astype(x.dtype)

    poisoned = list(args)
    poisoned[6] = garbage(~start[None], args[6])  # rp2a
    poisoned[7] = garbage(~now, args[7])  # rp2b
    poisoned[8] = garbage(~now, args[8])  # rvoted
    poisoned[9] = garbage(~newly, args[9])  # cv
    poisoned[10] = garbage(~newly, args[10])  # ra
    poisoned[11] = garbage(rv_needed, args[11])  # rv_lat
    poisoned[12] = garbage(newly, args[12])  # reply_lat
    got = _port(poisoned)
    for name, g in zip(tfo.FMP_VOTE_OUTS, got):
        assert torch.equal(out[name], g), name
    A, G, W = shape
    cells, slots = A * G * W, G * W
    n_start, n_new = int(start.sum()), int(newly.sum())
    lat = 4 * int(rv_needed.sum()) + 4 * n_new
    targs = registry.to_torch(args, "cpu")
    assert tfo.fmp_vote_needed_bytes(targs, **st) == (
        cells * 8 + slots * 13 + 4 * A * (slots - n_start)
        + 5 * (cells - int(now.sum())) + 8 * (slots - n_new) + lat
        + cells * 9 + slots * 25
    )
    assert tfo.fmp_vote_route_bytes(targs, **st) == (
        cells * 17 + slots * 21 + lat + cells * 9 + slots * 25
    )
    if case == "random":  # something poisoned
        assert (~rv_needed).any() and (~newly).any()
    if case == "random" and shape == (3, 3334, 32):  # in every field
        assert start.any() and now.any() and newly.any()
