"""The port's CRAQ chain plane (the plain PyTorch version, which the CUDA
kernel is held against on the card) against the JAX package's
``reference_craq_chain`` and its Pallas ``fused_craq_chain`` in interpret
mode: the same numpy inputs, all seven outputs equal, dtypes included, on
random and edge inputs (every slot arriving now, node-slot columns out of
range, zero hop latencies), with and without a partition that heals and
one that never heals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import craq as jcr
from frankenpaxos_tpu.tpu import craq_batched as jcb
from frankenpaxos_tpu_torch.ops import craq as tcr
from frankenpaxos_tpu_torch.ops import registry
from frankenpaxos_tpu_torch.tpu import craq_batched as tcb

SHAPES = [(5, 8, 3, 4), (3, 6, 4, 5)]  # N, W, L, KV
# side bits over the L nodes, partition start, heal (-1 = never); the
# cut is live at the example inputs' tick 40 in both partitioned rows.
PARTITIONS = {
    "none": lambda L: ((), 0, -1),
    "heals": lambda L: ((0,) * (L - 2) + (1, 0), 10, 55),
    "never_heals": lambda L: ((0, 1) + (0,) * (L - 2), 30, -1),
}

_DT = {
    np.dtype("int8"): torch.int8,
    np.dtype("int32"): torch.int32,
    np.dtype("bool"): torch.bool,
}


def _args(shape, case="random"):
    return tcr.example_craq_chain_args(
        np.random.default_rng(sum(shape)), *shape, case=case
    )


def _statics(shape, partition="none"):
    L, KV = shape[2], shape[3]
    side, start, heal = PARTITIONS[partition](L)
    return dict(
        tail=L - 1, num_keys=KV, side=side, partition_start=start,
        partition_heal=heal,
    )


def _jax_args(args):
    return tuple(
        jnp.asarray(a) if isinstance(a, np.ndarray) else jnp.int32(a)
        for a in args
    )


def _port(args, st):
    return tcr.reference_craq_chain(*registry.to_torch(args, "cpu"), **st)


def _assert_equal(jax_outs, port_outs):
    assert len(jax_outs) == len(port_outs) == len(tcr.CRAQ_CHAIN_OUTS)
    for name, j, p in zip(tcr.CRAQ_CHAIN_OUTS, jax_outs, port_outs):
        j = np.asarray(j)
        assert _DT[j.dtype] == p.dtype, f"{name}: {j.dtype} vs {p.dtype}"
        assert tuple(j.shape) == tuple(p.shape), name
        np.testing.assert_array_equal(j, p.numpy(), err_msg=name)


@pytest.mark.parametrize("partition", sorted(PARTITIONS))
@pytest.mark.parametrize("case", tcr.EDGE_CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_reference(shape, case, partition):
    args = _args(shape, case)
    st = _statics(shape, partition)
    _assert_equal(jcr.reference_craq_chain(*_jax_args(args), **st), _port(args, st))


@pytest.mark.parametrize(
    "case,partition",
    [("random", "none"), ("all_arrive", "heals"), ("out_of_range", "none"),
     ("zero_latency", "never_heals")],
)
def test_plain_version_matches_jax_interpret_kernel(case, partition):
    shape = SHAPES[0]
    args = _args(shape, case)
    st = _statics(shape, partition)
    kern = jcr.fused_craq_chain(*_jax_args(args), block=2, interpret=True, **st)
    _assert_equal(kern, _port(args, st))


def test_edge_inputs_do_what_they_say():
    """The cases reach the branches they name: same-slot collisions, the
    dropped columns, a zero-latency ack arriving in the same call, and a
    hop deferred to the heal tick (or to INF)."""
    shape = (6, 16, 4, 8)
    N, W, L, KV = shape
    args = registry.to_torch(_args(shape, "all_arrive"), "cpu")
    out = tcr.reference_craq_chain(*args, **_statics(shape))
    at_mid = (args[0] == tcr.W_DOWN) & (args[3] < L - 1)
    added = int(out[3].sum() - args[6].sum())
    assert added == int(at_mid.sum()) - int((args[0] == tcr.W_UP).sum())
    args = registry.to_torch(_args(shape, "out_of_range"), "cpu")
    wslot = args[3] * KV + args[1]
    assert bool(((wslot >= L * KV) | (wslot < -L * KV)).any())
    args = registry.to_torch(_args(shape, "zero_latency"), "cpu")
    out = tcr.reference_craq_chain(*args, **_statics(shape))
    assert bool((out[2] == 40).any())  # a zero-latency hop lands this tick
    args = registry.to_torch(_args(shape), "cpu")
    for partition, heal in (("heals", 55), ("never_heals", tcr.INF)):
        out = tcr.reference_craq_chain(*args, **_statics(shape, partition))
        assert bool((out[2] == heal).any()), partition


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_on_cpu_is_the_plain_version(shape):
    registry.reset_launches()
    args = registry.to_torch(_args(shape), "cpu")
    st = _statics(shape, "heals")
    got = tcr.fused_craq_chain(*args, **st)
    want = tcr.reference_craq_chain(*args, **st)
    for name, g, w in zip(tcr.CRAQ_CHAIN_OUTS, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert registry.LAUNCHES["craq_chain"] == 0


@pytest.mark.parametrize("shape", [(3, 40, 40, 3), (2, 1030, 2, 300)])
def test_kernel_checks_accept_every_config_shape(shape):
    """Any chain length, key count and window passes the wrapper's checks
    (everything before the CUDA library loads), a live partition too."""
    args = registry.to_torch(_args(shape), "cpu")
    st = _statics(shape, "never_heals")
    _, outs = tcr.prepared_launch(*args, **st)
    want = tcr.reference_craq_chain(*args, **st)
    assert [(o.shape, o.dtype) for o in outs] == [(w.shape, w.dtype) for w in want]
    bad = list(args)
    bad[6] = bad[6].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        tcr.prepared_launch(*bad, **st)


def test_slot_codes_and_registration():
    assert (tcr.W_EMPTY, tcr.W_DOWN, tcr.W_UP) == (
        jcb.W_EMPTY, jcb.W_DOWN, jcb.W_UP
    ) == (tcb.W_EMPTY, tcb.W_DOWN, tcb.W_UP)
    plane = registry.PLANES["craq_chain"]
    assert plane.backend == "craq"
    assert plane.source == "frankenpaxos_tpu_torch/csrc/craq.cu"
    assert plane.replaces.startswith("frankenpaxos_tpu/ops/craq.py:252 fused_craq_chain")


def test_wrapper_rejects_mixed_devices():
    args = list(registry.to_torch(_args(SHAPES[0]), "cpu"))
    args[6] = args[6].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        tcr.fused_craq_chain(*args, **_statics(SHAPES[0]))


def _odd_offset(x):
    """A contiguous view of x's values one element past its own base."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)
    return flat[1:].view(x.shape).copy_(x)


@pytest.mark.parametrize("shape,skew,block,route,cpb,threads", [
    ((2500, 16, 4, 64), None, 0, "vector", 2, 32),  # the main path
    ((25000, 16, 4, 64), None, 0, "vector", 2, 32),  # 100,000 chain nodes
    ((40, 12, 4, 8), None, 0, "vector", 2, 32),  # W = 12
    ((40, 8, 4, 8), None, 0, "vector", 4, 32),  # W = 8
    ((7, 5, 3, 8), None, 0, "vector", 6, 32),  # W = 5, small rows
    ((2500, 16, 4, 64), None, 64, "vector", 4, 64),  # a block of 64 threads
    ((2500, 16, 4, 64), 6, 0, "general", 0, 256),  # node_dirty misaligned
    ((2500, 16, 4, 64), 7, 0, "general", 0, 256),  # node_version misaligned
    ((2500, 16, 4, 64), 1, 0, "vector", 2, 32),  # a slot plane: read scalar
    ((33, 40, 5, 3), None, 0, "general", 0, 256),  # L*KV = 15
    ((3, 8, 2, 3072), None, 0, "vector", 1, 384),  # rows at 48 KB
    ((3, 8, 2, 3074), None, 0, "general", 0, 256),  # rows past it
    ((3, 8, 2, 3072), None, 32, "general", 0, 32),  # rows past a CTA's registers
    ((2, 1030, 2, 300), None, 0, "general", 0, 256),  # a slot a thread > 1024
])
def test_craq_chain_route(shape, skew, block, route, cpb, threads):
    """The route the wrapper asks the kernel for, from W, L*KV and the
    node planes' 16-byte alignment, and the vector route's chains and
    threads a CTA; prepared_launch on CPU tensors packs them."""
    args = list(registry.to_torch(_args(shape), "cpu"))
    if skew is not None:
        args[skew] = _odd_offset(args[skew])
        assert args[skew].is_contiguous() and args[skew].data_ptr() % 16
    assert tcr.craq_chain_route(*args, block=block) == route
    launch, _ = tcr.prepared_launch(*args, block, **_statics(shape))
    assert launch.route == route
    ints = list(launch.packed[1])
    assert ints[8:] == [threads, registry.ROUTES.index(route), cpb]
    if route == "vector":
        N, W, L, KV = shape
        assert cpb * W <= threads and 8 * cpb * L * KV <= tcr.VEC_SHARED_BYTES
        assert cpb * L * KV // 4 <= threads * tcr.VEC_ROW_VECS


def _hand_case():
    """N = 2 chains, W = 2 slots, L = 2 nodes of KV = 1 key, t = 40.
    (0, 0): a DOWN write arriving at the tail (node 1); (0, 1): a DOWN
    write arriving at the head (mid-chain), forwarded with latency 0;
    (1, 0): an UP ack arriving at the head (it retires); (1, 1): empty."""
    i32 = torch.int32
    status = torch.tensor([[tcr.W_DOWN, tcr.W_DOWN], [tcr.W_UP, tcr.W_EMPTY]],
                          dtype=torch.int8)
    key = torch.zeros((2, 2), dtype=i32)
    version = torch.tensor([[7, 8], [9, -1]], dtype=i32)
    node = torch.tensor([[1, 0], [0, 0]], dtype=i32)
    arrival = torch.tensor([[40, 40], [40, tcr.INF]], dtype=i32)
    issue = torch.tensor([[30, 31], [32, tcr.INF]], dtype=i32)
    planes = torch.zeros((2, 2), dtype=i32)
    lat = torch.tensor([[1, 0], [1, 1]], dtype=i32)
    return (status, key, version, node, arrival, issue, planes, planes.clone(),
            lat, 40)


def test_craq_chain_needed_bytes_counted_by_hand():
    args = _hand_case()
    st = dict(tail=1, num_keys=1)
    nodes = 2 * 2 * 2 * 4 * 2  # two [2, 2] int32 planes in and out
    slots = (
        4 * (1 + 4 + 4 + 4)  # status, arrival, node, latency of every slot
        + 3 * 4  # keys: the two DOWN arrivals and the ack
        + 2 * 4  # versions: the tail apply and the ack
        + 1 * 4  # issue tick: the tail apply
        + 4 * (1 + 4 + 4 + 1 + 4)  # the slot outputs
    )
    assert tcr.craq_chain_needed_bytes(args, **st) == nodes + slots == 196
    # A cut live at t = 40 adds the side bits the hops read.
    cut = dict(st, side=(0, 1), partition_start=30, partition_heal=55)
    assert tcr.craq_chain_needed_bytes(args, **cut) == 196 + 2
    # The forwarded write reaches the cut node at the heal tick, not now:
    # the counts do not move.
    assert int(tcr.reference_craq_chain(*args, **cut)[2][0, 1]) == 55


def _wrap(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def _slot_updates(args, st):
    """csrc/craq.cu's slot_step, a write slot at a time, on numpy inputs:
    each slot's outputs and its (chain, column, "add" | "max", value)
    updates to the node rows, columns outside the row included."""
    ws, wk, wv, wn, wa, wi, dirty, _, lat, t = args
    tail, KV = st["tail"], st["num_keys"]
    side, start, heal = st["side"], st["partition_start"], st["partition_heal"]
    live = any(side) and t >= start and (heal < 0 or t < heal)

    def hop(arrival, node):
        if live and 0 <= node < len(side) and side[node] == 1:
            return max(arrival, heal if heal >= 0 else tcr.INF)
        return arrival

    outs = {k: np.zeros(ws.shape, np.int64) for k in ("ws", "wn", "wa", "tail", "wlat")}
    updates = []
    for n, w in np.ndindex(ws.shape):
        s, a, node, t_lat = int(ws[n, w]), int(wa[n, w]), int(wn[n, w]), _wrap(t + int(lat[n, w]))
        key, ver = int(wk[n, w]), int(wv[n, w])
        down = s == tcr.W_DOWN and a == t
        mid, at_tail = down and node < tail, down and node == tail
        col = _wrap(node * KV + key)
        if mid:
            updates.append((n, col, "add", 1))
        if at_tail:
            updates.append((n, col, "max", ver))
        outs["wlat"][n, w] = _wrap(t_lat - int(wi[n, w])) if at_tail else 0
        outs["tail"][n, w] = at_tail
        node = node + 1 if mid else (tail - 1 if at_tail else node)
        s = tcr.W_UP if at_tail else s
        a = hop(t_lat, node) if down else a
        if s == tcr.W_UP and a == t:
            col = _wrap(node * KV + key)
            updates += [(n, col, "max", ver), (n, col, "add", -1)]
            if node == 0:
                s, a = tcr.W_EMPTY, tcr.INF
            else:
                node -= 1
                a = hop(t_lat, node)
        outs["ws"][n, w], outs["wn"][n, w], outs["wa"][n, w] = s, node, a
    return outs, updates


@pytest.mark.parametrize("partition", sorted(PARTITIONS))
@pytest.mark.parametrize("case", tcr.EDGE_CASES)
def test_slot_updates_commute(case, partition):
    """The vector route applies each write slot's adds and maxes to the
    chain's rows in shared memory, in whatever order the slots' threads
    reach them. Applied one at a time in several random orders, the
    slots' updates give the plain version's node planes every time, and
    the slots' own outputs are the plain version's."""
    shape = (5, 16, 4, 3)
    args = _args(shape, case)
    st = _statics(shape, partition)
    want = _port(args, st)
    outs, every = _slot_updates(args, st)
    for name, i in (("ws", 0), ("wn", 1), ("wa", 2), ("tail", 5), ("wlat", 6)):
        np.testing.assert_array_equal(outs[name], want[i].numpy(), err_msg=name)
    LKV = args[6].shape[1]
    updates = [u for u in every if 0 <= u[1] < LKV]  # the kernel drops the rest
    if case == "out_of_range":
        assert len(updates) < len(every)
    if case == "all_arrive":  # several slots update one column
        cols = [u[:2] for u in updates]
        assert len(set(cols)) < len(cols)
    rng = np.random.default_rng(len(updates))
    for _ in range(4):
        dirty = args[6].astype(np.int64)
        ver = args[7].astype(np.int64)
        for i in rng.permutation(len(updates)):
            n, col, op, v = updates[i]
            if op == "add":
                dirty[n, col] = _wrap(dirty[n, col] + v)
            else:
                ver[n, col] = max(ver[n, col], v)
        np.testing.assert_array_equal(dirty, want[3].numpy())
        np.testing.assert_array_equal(ver, want[4].numpy())
