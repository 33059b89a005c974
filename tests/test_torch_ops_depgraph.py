"""The port's dependency-graph plane against the JAX package: the bit
helpers (pack, unpack, clear, subset, the bit-sliced Bernoulli sweep) word
for word, and the plain version of the execute plane (the one the CUDA
kernel is held against on the card) against ``reference_depgraph_execute``,
the Pallas ``fused_depgraph_execute`` in interpret mode and the port's own
host oracle (a sequential Tarjan walk). A numpy model of the CUDA kernel's
schedule (``csrc/depgraph.cu``: active-list compaction, in-place squaring
of the bit rows to a fixed point, the per-row passes over the list) is
held against the same references, with its round count. Every comparison
is exact; the inputs carry garbage bits in the padding lanes past ``V``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.ops import depgraph as jdg
from frankenpaxos_tpu_torch import prng
from frankenpaxos_tpu_torch.ops import depgraph as tdg
from frankenpaxos_tpu_torch.ops import registry

SHAPES = [(3, 40), (2, 64)]  # B, V: V not a multiple of 32, and one that is


def _args(shape, case="random"):
    return tdg.example_depgraph_args(np.random.default_rng(sum(shape)), *shape, case=case)


def _port_args(args):
    adj, com, act = args
    return (
        torch.from_numpy(adj.view(np.int32).copy()),
        torch.from_numpy(com),
        torch.from_numpy(act),
    )


def _assert_equal(want, got):
    """``want``: JAX arrays or numpy; ``got``: the port's tensors."""
    for name, w, g in zip(tdg.DEPGRAPH_OUTS, want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert w.dtype == g.dtype, f"{name}: {w.dtype} vs {g.dtype}"
        np.testing.assert_array_equal(w, g, err_msg=name)


def _bits32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# A numpy model of the CUDA kernel's schedule, one graph at a time.
# ---------------------------------------------------------------------------


def _compact(pred):
    """The kernel's block compaction: the indices where ``pred`` holds, in
    order."""
    return [x for x, on in enumerate(pred) if on]


def _squaring_closure(rows, alist, aw, act_w, in_place):
    """Step 3 of the kernel: thread (p, k) owns word ``aw[k]`` of row
    ``alist[p]`` and ORs in that word of every row its row reaches (after
    the first round, of the reached rows written in the round before,
    unless its own row was), until a round changes nothing. ``in_place``:
    the pairs run one after the other and see each other's writes (one
    schedule the card may take); otherwise every pair reads the round's
    starting rows (the slowest). Returns the number of rounds, the last
    one included."""
    rounds = 0
    dirty = set(alist)  # the first round pulls every reached row
    while True:
        rounds += 1
        src = rows if in_place else rows.copy()
        wrote = set()
        for i in alist:
            pull_all = i in dirty
            for w in aw:
                old = int(rows[i, w])
                acc = old
                for wm in aw:
                    if acc == act_w[w]:
                        break
                    for lane in tdg.iter_bits(int(src[i, wm])):
                        if pull_all or wm * 32 + lane in dirty:
                            acc |= int(src[wm * 32 + lane, w])
                if acc != old:
                    rows[i, w] = acc
                    wrote.add(i)
        if not wrote:
            return rounds
        dirty = wrote


def _kernel_model(adj, committed, active, in_place=True):
    """One graph (``adj`` [V, VW] uint32, ``committed`` / ``active`` [V]
    bool) through the kernel's five steps (compaction, seed, squaring, the
    root by pairs and the per-row passes, the eligible list's rank);
    returns ``((eligible, order, scc_root), rounds)``."""
    V, VW = adj.shape
    act = np.zeros(VW * 32, bool)
    act[:V] = active
    unc = np.zeros(VW * 32, bool)
    unc[:V] = active & ~committed
    act_w = [sum(1 << lane for lane in range(32) if act[w * 32 + lane]) for w in range(VW)]
    unc_w = [sum(1 << lane for lane in range(32) if unc[w * 32 + lane]) for w in range(VW)]
    eligible = np.zeros(V, bool)
    order = np.full(V, -1, np.int32)
    root = np.full(V, -1, np.int32)
    alist = _compact(act[:V])
    if not alist:
        return (eligible, order, root), 0
    aw = _compact([x != 0 for x in act_w])
    rows = np.zeros((V, VW), np.int64)  # only active rows x active words are used
    for i in alist:
        for w in aw:
            rows[i, w] = int(adj[i, w]) & act_w[w]
        rows[i, i // 32] |= 1 << (i % 32)
    rounds = _squaring_closure(rows, alist, aw, act_w, in_place)
    sizes = []
    for i in alist:
        # The root: each pair's least mutually reachable j of its word, at
        # or below i, min-reduced over the row's pairs.
        root[i] = min(
            j
            for w in aw
            if w <= i // 32
            for j in (w * 32 + lane for lane in tdg.iter_bits(int(rows[i, w])))
            if j <= i and (int(rows[j, i // 32]) >> (i % 32)) & 1
        )
        bits = [int(rows[i, w]) for w in aw]
        size = sum(bin(x).count("1") for x in bits)
        bad = any(x & unc_w[w] for x, w in zip(bits, aw))
        eligible[i] = not bad
        sizes.append(-1 if bad else size)
    elig = [(i, s) for i, s in zip(alist, sizes) if s >= 0]
    for q, (i, s) in enumerate(elig):
        order[i] = sum(sr < s or (sr == s and r < q) for r, (_, sr) in enumerate(elig))
    return (eligible, order, root), rounds


def _path_depth(adj, active):
    """The most edges a shortest path between two active vertices takes
    (0 without edges): at most the longest path, and what the rounds of
    squaring must cover."""
    V = adj.shape[0]
    a = tdg.unpack_mask(torch.from_numpy(adj.view(np.int32)), V).numpy()
    a = a & active[:, None] & active[None, :] & ~np.eye(V, dtype=bool)
    reach, depth = a.copy(), 0
    frontier = a.copy()
    while frontier.any():
        depth += 1
        nxt = (frontier.astype(np.int64) @ a.astype(np.int64)) > 0
        frontier = nxt & ~reach
        reach |= nxt
    return depth


@pytest.mark.parametrize("in_place", [True, False], ids=["in_place", "synchronous"])
@pytest.mark.parametrize("case", tdg.EDGE_CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_schedule_matches_jax_reference_and_oracle(shape, case, in_place):
    """The kernel's schedule gives the reference's and the oracle's bits on
    every edge case, in place or round by round, and its rounds stay at
    most ceil(log2(longest path)) + 2; round by round they are exactly
    ceil(log2(depth)) + 1, the last round changing nothing."""
    args = _args(shape, case)
    want = jdg.reference_depgraph_execute(*(jnp.asarray(a) for a in args))
    for b in range(shape[0]):
        graph = [a[b] for a in args]
        got, rounds = _kernel_model(*graph, in_place=in_place)
        _assert_equal([np.asarray(w)[b] for w in want], [torch.from_numpy(g) for g in got])
        _assert_equal(tdg.oracle_execute(*graph), [torch.from_numpy(g) for g in got])
        if not graph[2].any():
            assert rounds == 0
            continue
        depth = _path_depth(graph[0], graph[2])
        log_depth = math.ceil(math.log2(max(depth, 1)))
        assert rounds <= log_depth + 2
        if not in_place:
            assert rounds == log_depth + 1
        if case == "long_path":
            assert depth == shape[1] - 1


@pytest.mark.parametrize("n", [1, 31, 32, 40, 97])
def test_pack_unpack_match_jax(n):
    b = np.random.default_rng(n).random((3, n)) < 0.5
    words = tdg.pack_mask(torch.from_numpy(b))
    assert words.dtype == torch.int32 and words.shape[-1] == tdg.num_words(n)
    assert tdg.num_words(n) == jdg.num_words(n)
    np.testing.assert_array_equal(_bits32(words), np.asarray(jdg.pack_mask(jnp.asarray(b))))
    np.testing.assert_array_equal(tdg.unpack_mask(words, n).numpy(), b)
    np.testing.assert_array_equal(
        np.asarray(jdg.unpack_mask(jnp.asarray(_bits32(words)), n)), b
    )


@pytest.mark.parametrize("V", [40, 64])
def test_clear_vertices_and_rows_subset_match_jax(V):
    adj, _, act = _args((2, V))
    vmask = np.random.default_rng(V + 1).random((2, V)) < 0.3
    allowed = tdg.pack_mask(torch.from_numpy(act))
    cleared = tdg.clear_vertices(_port_args((adj, act, act))[0], torch.from_numpy(vmask))
    j_cleared = jdg.clear_vertices(jnp.asarray(adj), jnp.asarray(vmask))
    np.testing.assert_array_equal(_bits32(cleared), np.asarray(j_cleared))
    got = tdg.rows_subset(cleared, allowed)
    want = jdg.rows_subset(j_cleared, jnp.asarray(_bits32(allowed)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


@pytest.mark.parametrize("k16", [0, 1, 4, 7, 15, 16])
def test_bernoulli_words_k16_matches_jax(k16):
    shape = (3, 2, 4)
    j = jdg.bernoulli_words_k16(jax.random.PRNGKey(9), jnp.int32(k16), shape)
    p = tdg.bernoulli_words_k16(prng.PRNGKey(9), k16, shape, "cpu")
    assert p.dtype == torch.int32
    np.testing.assert_array_equal(_bits32(p), np.asarray(j))


@pytest.mark.parametrize("case", tdg.EDGE_CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_reference_and_oracle(shape, case):
    args = _args(shape, case)
    got = tdg.reference_depgraph_execute(*_port_args(args))
    want = jdg.reference_depgraph_execute(*(jnp.asarray(a) for a in args))
    _assert_equal(want, got)
    for b in range(shape[0]):
        oracle = tdg.oracle_execute(*(a[b] for a in args))
        _assert_equal(oracle, [g[b] for g in got])
        j_oracle = jdg.oracle_execute(*(a[b] for a in args))
        _assert_equal(j_oracle, [g[b] for g in got])


@pytest.mark.parametrize("case", ["random", "one_cycle"])
def test_plain_version_matches_jax_interpret_kernel(case):
    args = _args(SHAPES[0], case)
    kern = jdg.fused_depgraph_execute(
        *(jnp.asarray(a) for a in args), block=2, interpret=True
    )
    _assert_equal(kern, tdg.reference_depgraph_execute(*_port_args(args)))


def test_edge_inputs_do_what_they_say():
    """The random case has a multi-vertex SCC and ineligible vertices; the
    one-cycle case makes every active vertex one SCC; the padding garbage
    is really there; the empty graph has nothing active."""
    shape = (3, 40)
    adj, com, act = _args(shape)
    assert (adj[..., -1] >> np.uint32(40 - 32)).any()  # garbage past V
    elig, order, root = tdg.reference_depgraph_execute(*_port_args((adj, com, act)))
    assert bool(((root >= 0) & (root != torch.arange(40))).any())
    assert bool((torch.from_numpy(act) & ~elig).any()) and bool(elig.any())
    assert sorted(order[0][elig[0]].tolist()) == list(range(int(elig[0].sum())))
    _, _, root = tdg.reference_depgraph_execute(*_port_args(_args(shape, "one_cycle")))
    assert bool((root == 0).all())
    elig, order, root = tdg.reference_depgraph_execute(*_port_args(_args(shape, "empty")))
    assert not elig.any() and bool((order == -1).all()) and bool((root == -1).all())
    # The long path: vertex i reaches 0..i, so it is eligible exactly while
    # no uncommitted vertex lies at or below it, and it is its own root.
    adj, com, act = _args(shape, "long_path")
    assert act.all() and 1 <= (~com).sum(axis=1).min()
    elig, order, root = tdg.reference_depgraph_execute(*_port_args((adj, com, act)))
    first_unc = np.argmax(~com, axis=1)
    ids = np.arange(40)
    np.testing.assert_array_equal(elig.numpy(), ids[None, :] < first_unc[:, None])
    assert bool((root == torch.arange(40)).all())
    np.testing.assert_array_equal(order.numpy(), np.where(elig.numpy(), ids[None, :], -1))


def test_wrapper_on_cpu_is_the_plain_version_and_takes_a_shared_graph():
    registry.reset_launches()
    adj, com, act = _port_args(_args(SHAPES[0]))
    shared = adj[:1].expand(adj.shape)
    for a in (adj, shared):
        got = tdg.fused_depgraph_execute(a, com, act)
        _assert_equal(
            [w.numpy() for w in tdg.reference_depgraph_execute(a.contiguous(), com, act)],
            got,
        )
    assert registry.LAUNCHES["depgraph_execute"] == 0


@pytest.mark.parametrize("B,V", [(5, 320), (5, 1280), (4, 33), (2, 1314), (2, 1315)])
def test_kernel_checks_accept_every_window(B, V):
    """Any window passes the wrapper's checks (everything before the CUDA
    library loads): a working set past the 227 KB a Hopper block may opt
    in to (V > 1314) gets a global scratch buffer, V = 1280 stays in
    shared memory, and a stride-0 shared graph is taken as it is."""
    VW = tdg.num_words(V)
    adj = torch.zeros((1, V, VW), dtype=torch.int32).expand(B, V, VW)
    com = torch.zeros((B, V), dtype=torch.bool)
    launch, outs = tdg.prepared_launch(adj, com, com.clone())
    assert [(tuple(o.shape), o.dtype) for o in outs] == [
        ((B, V), torch.bool), ((B, V), torch.int32), ((B, V), torch.int32)
    ]
    assert (tuple(launch.rounds.shape), launch.rounds.dtype) == ((B,), torch.int32)
    nbytes, shared = tdg.working_set(V)
    assert tdg.SHARED_BYTES == 232448 and nbytes == 4 * tdg.scratch_words(V)
    assert shared == (nbytes <= tdg.SHARED_BYTES) == (V <= 1314)
    assert 128 <= tdg.default_threads(V) <= 1024 and tdg.default_threads(V) % 32 == 0
    with pytest.raises(ValueError, match="strides"):
        tdg.prepared_launch(adj.transpose(1, 2).contiguous().transpose(1, 2), com, com)
    with pytest.raises(TypeError, match="int32"):
        tdg.prepared_launch(adj.to(torch.int64), com, com)


def test_registration():
    plane = registry.PLANES["depgraph_execute"]
    assert plane.backend == "bpaxos"
    assert plane.source == "frankenpaxos_tpu_torch/csrc/depgraph.cu"
    assert plane.replaces.startswith(
        "frankenpaxos_tpu/ops/depgraph.py:282 fused_depgraph_execute"
    )
