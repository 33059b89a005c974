"""The port's Scalog cut-commit plane (the plain PyTorch version, which the
CUDA kernel is held against on the card) against the JAX package's
``reference_scalog_cut_commit`` and its Pallas ``fused_scalog_cut_commit``
in interpret mode: the same numpy inputs, all seven outputs equal, dtypes
included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import scalog as jsc
from frankenpaxos_tpu_torch.ops import registry
from frankenpaxos_tpu_torch.ops import scalog as tsc

# P, S: small, a ragged S, and an S over more than one Pallas block (512).
SHAPES = [(4, 5), (8, 9), (8, 1030)]
CASES = list(tsc.EDGE_CASES)

_DT = {
    np.dtype("int32"): torch.int32,
    np.dtype("bool"): torch.bool,
}


def _args(shape, case="random", seed=0):
    return tsc.example_scalog_cut_commit_args(
        np.random.default_rng(sum(shape) + seed), *shape, case=case
    )


def _jax_args(args):
    return tuple(
        jnp.asarray(a) if isinstance(a, np.ndarray) else jnp.int32(a)
        for a in args
    )


def _assert_equal(jax_outs, port_outs):
    assert len(jax_outs) == len(port_outs) == len(tsc.SCALOG_CUT_COMMIT_OUTS)
    for name, j, p in zip(tsc.SCALOG_CUT_COMMIT_OUTS, jax_outs, port_outs):
        j = np.asarray(j)
        assert _DT[j.dtype] == p.dtype, f"{name}: {j.dtype} vs {p.dtype}"
        assert tuple(j.shape) == tuple(p.shape), name
        np.testing.assert_array_equal(j, p.numpy(), err_msg=name)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_reference(shape, case):
    for seed in range(3):
        args = _args(shape, case, seed)
        port = tsc.reference_scalog_cut_commit(*registry.to_torch(args, "cpu"))
        _assert_equal(jsc.reference_scalog_cut_commit(*_jax_args(args)), port)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_interpret_kernel(shape, case):
    args = _args(shape, case)
    port = tsc.reference_scalog_cut_commit(*registry.to_torch(args, "cpu"))
    kern = jsc.fused_scalog_cut_commit(*_jax_args(args), interpret=True)
    _assert_equal(kern, port)


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_on_cpu_is_the_plain_version(shape):
    registry.reset_launches()
    args = registry.to_torch(_args(shape), "cpu")
    got = tsc.fused_scalog_cut_commit(*args)
    want = tsc.reference_scalog_cut_commit(*args)
    for name, g, w in zip(tsc.SCALOG_CUT_COMMIT_OUTS, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert registry.LAUNCHES["scalog_cut_commit"] == 0


def test_example_inputs_reach_every_branch():
    """The edge cases commit what they say; the lags meet a floor division
    of a negative number; the ring walk wraps."""
    P, S = 8, 64

    def run(case, seed=0):
        args = registry.to_torch(_args((P, S), case, seed), "cpu")
        return args, tsc.reference_scalog_cut_commit(*args)

    _, out = run("none_live")
    assert not bool(out[1].any()) and int(out[2].sum()) == 0
    args, out = run("all_committed")
    assert bool(out[1].all()) and bool(out[4].all())
    assert bool((out[5] == tsc.INF).all())
    _, out = run("gap")
    assert int(out[1].sum()) == P // 2 and bool(out[1][: P // 2].all())
    args, out = run("wrap")
    cc = int(args[5])
    assert cc % P != 0 and int(out[1].sum()) == P - 1
    assert torch.equal(out[0], args[0][(cc + P - 2) % P])
    snap, prev = args[2], args[3]
    assert bool(((snap - prev + 1) < 0).any())  # the floor division's case
    assert int(out[2].sum()) == int((out[0] - args[4]).sum())


def test_registration():
    plane = registry.PLANES["scalog_cut_commit"]
    assert plane.backend == "scalog"
    assert plane.source == "frankenpaxos_tpu_torch/csrc/scalog.cu"
    assert plane.replaces.startswith(
        "frankenpaxos_tpu/ops/scalog.py:184 fused_scalog_cut_commit"
    )


def test_wrapper_rejects_mixed_devices():
    args = list(registry.to_torch(_args((4, 5)), "cpu"))
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        tsc.fused_scalog_cut_commit(*args)


@pytest.mark.parametrize("case", ["random", "wrap", "all_committed"])
@pytest.mark.parametrize("shape", [(40, 9), (70, 33)])
def test_kernel_checks_accept_deep_pipelines(shape, case):
    """The wrapper's checks take P > 32 cuts in flight (the wide kernel on
    the card); the plain version there equals the JAX reference."""
    args = _args(shape, case)
    torch_args = registry.to_torch(args, "cpu")
    _, outs = tsc.prepared_launch(*torch_args)
    port = tsc.reference_scalog_cut_commit(*torch_args)
    assert [(o.shape, o.dtype) for o in outs] == [(p.shape, p.dtype) for p in port]
    _assert_equal(jsc.reference_scalog_cut_commit(*_jax_args(args)), port)


@pytest.mark.parametrize("shape,route", [
    ((8, 10000), "cluster"),  # the main shapes
    ((8, 256), "cluster"),
    ((8, 16384), "general"),  # one trip of the cluster (8 x 1024 x 2), but
    ((8, 12001), "general"),  # past the last shards it won at
    ((8, 100000), "general"),  # 10x
    ((2, 5), "cluster"),
    ((16, 8192), "cluster"),  # one trip of the cluster: 8 x 512 x 2
    ((16, 8193), "general"),
    ((32, 2500), "general"),  # more cuts than a cluster thread holds
    ((17, 0), "general"),
    ((33, 64), "general"),
    ((40, 10000), "general"),  # the repaired wide pipeline
    ((8, 12000), "cluster"),
    ((16, 0), "cluster"),
])
def test_scalog_cut_commit_route(shape, route):
    """The route the wrapper asks the kernel for, from P and S;
    prepared_launch on CPU tensors takes it and packs {P, S, t, threads of
    the general route, route code}."""
    args = registry.to_torch(_args(shape), "cpu")
    assert tsc.scalog_cut_commit_route(*args[:-1]) == route
    launch, _ = tsc.prepared_launch(*args)
    assert launch.route == route
    P, S = shape
    assert list(launch.packed[1]) == [P, S, args[-1], 256,
                                      registry.ROUTES.index(route)]
    launch, _ = tsc.prepared_launch(*args, block=64)
    assert list(launch.packed[1])[3] == 64


@pytest.mark.parametrize("P", [1, 8, 9, 16, 17, 32, 40])
def test_cluster_max_shards(P):
    """One trip of the cluster, as csrc/scalog.cu's launcher takes it:
    8 CTAs of 1024 threads up to 8 cuts, of 512 up to 16, 2 shards a
    thread; no shards past 16 cuts."""
    want = {1: 16384, 8: 16384, 9: 8192, 16: 8192}.get(P, 0)
    assert tsc.cluster_max_shards(P) == want


def test_needed_bytes_counts_the_committing_rows():
    """The bound's bytes: 8 a shard, 4 a shard for each committing cut,
    30 a ring slot and the two counters."""
    for case, n in (("none_live", 0), ("all_committed", 8), ("gap", 4)):
        args = registry.to_torch(_args((8, 100), case), "cpu")
        assert int(tsc.reference_scalog_cut_commit(*args)[1].sum()) == n
        assert tsc.scalog_cut_commit_needed_bytes(*args) == (
            100 * 8 + n * 100 * 4 + 8 * 30 + 8)


INT32_MAX = 2**31 - 1


def _cluster_model(cut_vec, commit, snap, prev, last, cc, nc, t):
    """The cluster route's arithmetic in numpy, as csrc/scalog.cu
    scalog_one_kernel runs it: the ballot over issue order with each
    slot's tick fetched from its ring lane; each ring row's sum over
    shards and last_committed_cut's, every add wrapping in int32; the
    record count of issue order i as the difference of its row's sum and
    its predecessor's (the deltas telescope); the newest committed row as
    the new cut; slot j's owner (j - committed_cuts) mod P, or past
    INT_MAX the last issue order that lives there."""
    P, S = cut_vec.shape
    w = lambda x: np.asarray(x, np.int64).astype(np.uint32).astype(np.int32)  # noqa: E731
    cc, nc = int(cc), int(nc)
    lane = np.arange(P)
    idx = w(cc + lane)
    my_slot = np.mod(idx.astype(np.int64), P)
    ok = (idx < nc) & (commit[my_slot] <= t)
    n = int(np.argmin(np.append(ok, False)))  # the committed prefix
    sums = cut_vec.astype(np.int64).sum(axis=1)
    sum_last = int(last.astype(np.int64).sum())
    before = np.array([sum_last] + [sums[my_slot[i - 1]] for i in range(1, P)])
    recs = np.where(lane < n, sums[my_slot] - before, 0)
    cut = cut_vec[my_slot[n - 1]] if n > 0 else last
    if cc <= INT32_MAX - (P - 1):
        owner = (lane - cc % P) % P
    else:
        owner = np.array([max([k for k in range(P) if my_slot[k] == j], default=-1)
                          for j in range(P)])
    committed = lane < n
    s_i, p_i = snap[my_slot].astype(np.int64), prev[my_slot].astype(np.int64)
    lag = np.where(committed, (t - s_i) + np.floor_divide(s_i - p_i + 1, 2), 0)
    sc = (owner >= 0) & (owner < n)
    inf = tsc.INF
    return (w(cut), committed, w(recs), w(lag), sc,
            np.where(sc, inf, commit).astype(np.int32),
            np.where(sc, inf, snap).astype(np.int32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", [(8, 33), (2, 5), (16, 17), (5, 9)])
def test_cluster_route_model_matches_plain_version(shape, case):
    """The numpy model of the cluster route equals the plain version on
    every edge case, and where committed_cuts + P - 1 passes INT_MAX."""
    for seed in range(3):
        args = _args(shape, case, seed)
        got = _cluster_model(*args)
        want = tsc.reference_scalog_cut_commit(*registry.to_torch(args, "cpu"))
        for name, g, w in zip(tsc.SCALOG_CUT_COMMIT_OUTS, got, want):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    for nc in (INT32_MAX, -(2**31) + 3, INT32_MAX - 7):
        args = list(_args(shape, "all_committed"))
        args[5], args[6] = np.array(INT32_MAX - 3, np.int32), np.array(nc, np.int32)
        got = _cluster_model(*args)
        want = tsc.reference_scalog_cut_commit(*registry.to_torch(args, "cpu"))
        for name, g, w in zip(tsc.SCALOG_CUT_COMMIT_OUTS, got, want):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=f"{name} next_cut={nc}")
