"""Bounded-window dependency-graph execution: the bit helpers, the host
oracle, the plain PyTorch version of the execute plane and the wrapper of
its hand-written CUDA kernel (``csrc/depgraph.cu``).

The counterpart of ``frankenpaxos_tpu/ops/depgraph.py``. A graph over a
window of ``V`` vertices is a ``[V, VW]`` adjacency bitmask, ``VW =
ceil(V/32)`` words a row (bit ``j`` of row ``i``: instance ``i`` depends
on instance ``j``; vertex ``j`` is word ``j // 32``, lane ``j % 32``).
JAX keeps the words as uint32; the port keeps the same bit patterns in
int32 tensors (torch's uint32 has no shifts or comparisons on the CPU;
int32 ``& | ~ ^`` are the same bits, and ``(x >> s) & 1`` reads bit ``s``
even with an arithmetic shift). ``bpaxos_batched.state_to_numpy`` hands
the adjacency out as uint32, equal to JAX's bit for bit.

One plane of ``tpu/bpaxos_batched.py`` dispatches here:
``depgraph_execute`` (:func:`fused_depgraph_execute`, replaces the
Pallas ``fused_depgraph_execute`` at ``frankenpaxos_tpu/ops/depgraph.py:282``).
For each graph of a ``[B, V, VW]`` batch it computes the transitive
closure of the ACTIVE subgraph (edges restricted to active x active, the
padding lanes past ``V`` inactive), then

* ``eligible``: active, and no active uncommitted vertex in the closure;
* ``order``: the dense rank of the eligible vertices by (closure size,
  id), -1 where not eligible;
* ``scc_root``: the least mutually reachable id, -1 where inactive.

The outputs depend only on the closure, so any schedule that reaches the
full closure gives the same bits. The JAX twin doubles float32 0/1
matrices (exact while the counts stay below 2**24); the port's plain
version runs Warshall's algorithm on the bit rows, word-wise ORs only:
for each vertex ``k``, every row holding bit ``k`` ORs in row ``k``. The
CUDA kernel squares the bit rows of the active vertices in place to a
fixed point instead (a few rounds, one barrier each; ``csrc/depgraph.cu``).
:func:`oracle_execute` is the host-side sequential pointer walk (an
iterative Tarjan plus condensation reach sets), a second check.

Bound: operations. Warshall does ``V * V * VW`` word ORs a graph at most
(each row that holds bit ``k`` ORs ``VW`` words), against ``4 V VW`` bytes
in and ``9 V`` bytes out.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from frankenpaxos_tpu_torch import prng
from frankenpaxos_tpu_torch.ops import registry
from frankenpaxos_tpu_torch.ops.registry import on_cpu

_LANES = 32
_SOURCE = "frankenpaxos_tpu_torch/csrc/depgraph.cu"
_PLANE = "depgraph_execute"

DEPGRAPH_OUTS = ("eligible", "order", "scc_root")


def num_words(n: int) -> int:
    """Packed 32-bit words covering ``n`` vertices."""
    return -(-n // _LANES)


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


# ---------------------------------------------------------------------------
# Packed-word helpers
# ---------------------------------------------------------------------------


def pack_mask(b: torch.Tensor) -> torch.Tensor:
    """[..., n] bool -> [..., ceil(n/32)] int32 words (vertex v -> word
    v // 32, lane v % 32)."""
    n = b.shape[-1]
    nw = num_words(n)
    pad = nw * _LANES - n
    if pad:
        b = torch.cat([b, b.new_zeros(b.shape[:-1] + (pad,))], dim=-1)
    lanes = torch.ones(_LANES, dtype=torch.int64, device=b.device) << torch.arange(
        _LANES, dtype=torch.int64, device=b.device
    )
    words = b.reshape(b.shape[:-1] + (nw, _LANES)).to(torch.int64)
    return _to_int32_bits((words * lanes).sum(dim=-1))


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """[..., VW] int32 -> [..., VW*32] bool."""
    shifts = torch.arange(_LANES, dtype=torch.int32, device=words.device)
    bits = ((words[..., None] >> shifts) & 1) == 1
    return bits.reshape(words.shape[:-1] + (words.shape[-1] * _LANES,))


def unpack_mask(words: torch.Tensor, n: int) -> torch.Tensor:
    """[..., ceil(n/32)] int32 -> [..., n] bool: :func:`pack_mask`'s
    inverse."""
    assert words.shape[-1] * _LANES >= n
    return _unpack_bits(words)[..., :n]


def clear_vertices(adj: torch.Tensor, vmask: torch.Tensor) -> torch.Tensor:
    """Retire vertices: zero their ROWS (their own dependencies) and their
    COLUMNS (every other row's edges onto them), so a reused ring slot
    inherits no stale dependency. ``adj``: [..., V, VW] int32; ``vmask``:
    [..., V] bool."""
    words = pack_mask(vmask)  # [..., VW]
    rows_cleared = torch.where(vmask[..., :, None], 0, adj)
    return rows_cleared & ~words[..., None, :]


def rows_subset(adj: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """[..., V] bool: every dependency bit of each row lies inside the
    ``allowed`` word mask ([..., VW])."""
    return torch.all((adj & ~allowed[..., None, :]) == 0, dim=-1)


def bernoulli_words_k16(key: torch.Tensor, k16: int, shape, device=None):
    """Per-BIT Bernoulli(k16/16) over packed words: a bit-sliced 4-bit
    comparator over 4 random planes (``prng.bits`` of ``(4, *shape)``);
    a lane sets iff its 4-bit value is below ``k16`` (a Python int in
    [0, 16]). Returns int32 words."""
    k16 = int(k16)
    shape = tuple(shape)
    mask = 0xFFFFFFFF
    if k16 >= 16:
        return torch.full(shape, -1, dtype=torch.int32, device=device)
    planes = prng.bits(key, (4,) + shape, device)  # int64 in [0, 2**32)
    lt = torch.zeros(shape, dtype=torch.int64, device=device)
    eq = torch.full(shape, mask, dtype=torch.int64, device=device)
    for i in (3, 2, 1, 0):  # MSB -> LSB of the 4-bit value
        b = planes[i]
        if (k16 >> i) & 1:
            lt = lt | (eq & ~b & mask)
            eq = eq & b
        else:
            eq = eq & ~b & mask
    return _to_int32_bits(lt)


# ---------------------------------------------------------------------------
# Plain version (the specification the kernel is held against)
# ---------------------------------------------------------------------------


def reference_depgraph_execute(
    adj: torch.Tensor,  # [B, V, VW] int32 packed adjacency
    committed: torch.Tensor,  # [B, V] bool
    active: torch.Tensor,  # [B, V] bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(eligible [B, V] bool, order [B, V] int32, scc_root
    [B, V] int32)`` (module docstring)."""
    B, V, VW = adj.shape
    dev = adj.device
    act_words = pack_mask(active)  # [B, VW]; the padding lanes are 0
    self_words = pack_mask(torch.eye(V, dtype=torch.bool, device=dev))  # [V, VW]
    rows = torch.where(active[..., None], adj & act_words[:, None, :], 0)
    rows = rows | self_words[None]
    # Warshall: after step k every row holds what it reaches through
    # intermediates <= k. Row k holds bit k, so it does not change in
    # its own step and the whole step can read it.
    for k in range(V):
        has_k = ((rows[:, :, k // _LANES] >> (k % _LANES)) & 1) == 1  # [B, V]
        rows = torch.where(has_k[..., None], rows | rows[:, k : k + 1, :], rows)

    unc_words = pack_mask(active & ~committed)  # [B, VW]
    bad = torch.any((rows & unc_words[:, None, :]) != 0, dim=-1)
    eligible = active & ~bad
    reach = _unpack_bits(rows)[..., :V]  # [B, V, V]
    size = reach.sum(dim=-1, dtype=torch.int32)
    mutual = reach & reach.transpose(1, 2)
    ids = torch.arange(V, dtype=torch.int32, device=dev)
    root = torch.amin(torch.where(mutual, ids, V), dim=-1).to(torch.int32)
    root = torch.where(active, root, -1)
    n_i, n_k = size[:, :, None], size[:, None, :]
    less = (n_k < n_i) | ((n_k == n_i) & (ids[None, :] < ids[:, None]))
    rank = (less & eligible[:, None, :]).sum(dim=-1, dtype=torch.int32)
    order = torch.where(eligible, rank, -1)
    return eligible, order, root


# ---------------------------------------------------------------------------
# Host-side sequential pointer walk (the oracle of the tests)
# ---------------------------------------------------------------------------


def iter_bits(mask: int):
    """Iterate the set-bit positions of a Python int, lowest first."""
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low


def oracle_execute(adj, committed, active):
    """The plane's semantics by SEQUENTIAL POINTER WALK: an iterative
    Tarjan over the active subgraph plus condensation reach sets, one
    vertex at a time (the control flow of TarjanDependencyGraph.scala).
    Host only, numpy and Python ints. One graph: ``adj`` [V, VW] words
    (uint32, or int32 with the same bits), ``committed`` / ``active`` [V]
    bool. Returns ``(eligible, order, scc_root)`` as numpy arrays."""
    adj = np.asarray(adj).astype(np.int64) & 0xFFFFFFFF
    committed = np.asarray(committed, dtype=bool)
    active = np.asarray(active, dtype=bool)
    V = adj.shape[0]
    act_int = sum(1 << v for v in range(V) if active[v])
    deps = []
    for v in range(V):
        row = 0
        for w in range(adj.shape[1]):
            row |= int(adj[v, w]) << (w * _LANES)
        row &= (1 << V) - 1
        deps.append(row & act_int if active[v] else 0)

    # Iterative Tarjan over the active vertices.
    index = [-1] * V
    lowlink = [0] * V
    on_stack = [False] * V
    stack: list = []
    comp_of = [-1] * V
    comps: list = []  # member bitmasks, in pop (reverse topological) order
    counter = 0
    for start in range(V):
        if not active[start] or index[start] >= 0:
            continue
        work = [(start, iter_bits(deps[start]))]
        index[start] = lowlink[start] = counter
        counter += 1
        stack.append(start)
        on_stack[start] = True
        while work:
            v, it = work[-1]
            advanced = False
            for u in it:
                if index[u] < 0:
                    index[u] = lowlink[u] = counter
                    counter += 1
                    stack.append(u)
                    on_stack[u] = True
                    work.append((u, iter_bits(deps[u])))
                    advanced = True
                    break
                if on_stack[u]:
                    lowlink[v] = min(lowlink[v], index[u])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                lowlink[parent] = min(lowlink[parent], lowlink[v])
            if lowlink[v] == index[v]:
                members = 0
                while True:
                    u = stack.pop()
                    on_stack[u] = False
                    comp_of[u] = len(comps)
                    members |= 1 << u
                    if u == v:
                        break
                comps.append(members)

    # Condensation reach sets: a component pops after its successors.
    reach = []
    for members in comps:
        r = members
        succ = 0
        for u in iter_bits(members):
            succ |= deps[u]
        for u in iter_bits(succ & ~members):
            r |= reach[comp_of[u]]
        reach.append(r)

    committed_int = sum(1 << v for v in range(V) if committed[v])
    eligible = np.zeros((V,), bool)
    size = np.zeros((V,), np.int64)
    root = np.full((V,), -1, np.int32)
    for v in range(V):
        if not active[v]:
            continue
        rv = reach[comp_of[v]]
        eligible[v] = (rv & ~committed_int) == 0
        size[v] = bin(rv).count("1")
        members = comps[comp_of[v]]
        root[v] = (members & -members).bit_length() - 1
    order = np.full((V,), -1, np.int32)
    elig_ids = [v for v in range(V) if eligible[v]]
    for rank, v in enumerate(sorted(elig_ids, key=lambda v: (size[v], v))):
        order[v] = rank
    return eligible, order, root


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# Pointer slots of the kernel's argument block, in the order of the `Slot`
# enum of csrc/depgraph.cu.
_PTR_SLOTS = ("adj", "com", "act", "work", "o_elig", "o_order", "o_root", "o_rounds")

# Shared memory a graph may use before the kernel works from a global
# scratch buffer instead: the most a Hopper block may opt in to (227 KB).
# The kernel takes no static shared memory.
SHARED_BYTES = 232448


def scratch_words(V: int) -> int:
    """32-bit words of per-graph working memory: the closure rows, the
    active, active-uncommitted and active-word lists and three dirty masks
    (``VW`` words each), the active list and the closure sizes (``V``
    each) and 32 warp counts."""
    VW = num_words(V)
    return V * VW + 6 * VW + 2 * V + 32


def working_set(V: int) -> Tuple[int, bool]:
    """``(bytes, shared)``: a graph's working memory, and whether it lies in
    shared memory (else in a global scratch buffer). In shared memory up to
    V = 1314."""
    nbytes = 4 * scratch_words(V)
    return nbytes, nbytes <= SHARED_BYTES


def default_threads(V: int) -> int:
    """Threads a block when the caller names none: enough for a graph's
    (row, word) pairs up to 1024, at least 128."""
    want = -(-V * num_words(V) // 32) * 32
    return min(1024, max(128, want))


def _depgraph_kernel(adj, committed, active, block: int = 0):
    """Check the tensors, allocate the outputs (and the global scratch
    where a graph's working memory exceeds :data:`SHARED_BYTES`) and pack
    the launch; returns ``(launch, outputs)``. ``launch.rounds`` is an int32
    ``[B]`` tensor that each launch fills with its graphs' rounds of
    squaring. The launch loads the CUDA library, so the checks run without
    a card.

    ``adj`` may be a stride-0 broadcast of one ``[V, VW]`` graph over the
    batch (``expand``): the kernel takes the batch stride and reads the
    shared rows once a graph, no copy."""
    from frankenpaxos_tpu_torch.ops import _build

    if adj.dim() != 3:
        raise ValueError(f"{_PLANE}: adj has shape {tuple(adj.shape)}, want [B, V, VW]")
    B, V, VW = adj.shape
    if VW != num_words(V):
        raise ValueError(f"{_PLANE}: {VW} words a row for V={V}, want {num_words(V)}")
    if adj.dtype != torch.int32:
        raise TypeError(f"{_PLANE}: adj has dtype {adj.dtype}, want torch.int32")
    if adj.stride(2) != 1 or adj.stride(1) != VW or adj.stride(0) not in (0, V * VW):
        raise ValueError(
            f"{_PLANE}: adj strides {adj.stride()}: want each graph's rows "
            f"contiguous and a batch stride of {V * VW} or 0 (one shared graph)"
        )
    for name, x in (("committed", committed), ("active", active)):
        if tuple(x.shape) != (B, V):
            raise ValueError(f"{_PLANE}: {name} has shape {tuple(x.shape)}, want {(B, V)}")
        if x.dtype != torch.bool:
            raise TypeError(f"{_PLANE}: {name} has dtype {x.dtype}, want torch.bool")
        if not x.is_contiguous():
            raise ValueError(f"{_PLANE}: {name} is not contiguous")
    threads = block if block > 0 else default_threads(V)
    if not 32 <= threads <= 1024 or threads % 32:
        raise ValueError(
            f"{_PLANE}: block={threads} threads, want a multiple of 32 in 32-1024"
        )
    words = scratch_words(V)
    if B * words >= 2**31:
        raise ValueError(f"{_PLANE}: {B} graphs of V={V} exceed int32 offsets")
    _, shared = working_set(V)
    dev = adj.device
    outs = dict(
        o_elig=torch.empty((B, V), dtype=torch.bool, device=dev),
        o_order=torch.empty((B, V), dtype=torch.int32, device=dev),
        o_root=torch.empty((B, V), dtype=torch.int32, device=dev),
        o_rounds=torch.empty((B,), dtype=torch.int32, device=dev),
    )
    work = None if shared else torch.empty((B, words), dtype=torch.int32, device=dev)
    tensors = dict(adj=adj, com=committed, act=active, work=work, **outs)
    ints = (ctypes.c_int * 6)(B, V, VW, adj.stride(0), int(shared), threads)

    def launch() -> None:
        # The pointers are taken here, so the launch holds the scratch.
        ptrs = (ctypes.c_void_p * len(_PTR_SLOTS))(
            *[None if tensors[s] is None else tensors[s].data_ptr() for s in _PTR_SLOTS]
        )
        lib = _build.kernel_lib("fpx_depgraph", len(_PTR_SLOTS))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fpx_depgraph_launch(ptrs, ints, stream)
        if err != 0:
            raise RuntimeError(
                f"{_PLANE}: kernel launch failed: "
                f"{lib.fpx_error_string(err).decode()} (cuda error {err})"
            )
        registry.count_launch(_PLANE)

    launch.rounds = outs["o_rounds"]
    return launch, (outs["o_elig"], outs["o_order"], outs["o_root"])


def fused_depgraph_execute(adj, committed, active, block: int = 0):
    """:func:`reference_depgraph_execute` as one CUDA kernel on the card
    (the plain version on the CPU). Replaces the Pallas
    ``fused_depgraph_execute`` (frankenpaxos_tpu/ops/depgraph.py:282).
    One CTA per graph: the active vertices compacted, their bit rows
    squared in place to the closure (one barrier a round), then the
    eligibility, size, root and rank passes over the active list.
    Bit-exact: word-wise ORs and integer counts only. A failed launch (or
    shared-memory opt-in) raises; nothing falls back."""
    args = (adj, committed, active)
    if on_cpu(args):
        return reference_depgraph_execute(*args)
    launch, out = _depgraph_kernel(*args, block=block)
    launch()
    return out


def prepared_launch(*args, **statics) -> tuple:
    """For timing the kernel apart from its wrapper: checks the tensors
    ``args`` (the wrapper's arguments), allocates the outputs and returns
    ``(launch, outputs)``; each ``launch()`` runs the kernel once into
    those outputs (and counts as a launch), and ``launch.rounds`` with each
    graph's rounds of squaring. On CPU tensors it runs the wrapper's checks
    alone: only the launch needs the card."""
    return _depgraph_kernel(*args, **statics)


# ---------------------------------------------------------------------------
# Example inputs: numpy arrays, from a seed.
# ---------------------------------------------------------------------------

EDGE_CASES = ("random", "all_committed", "empty", "one_cycle", "long_path")


def example_depgraph_args(rng, B, V, case="random", density=0.12):
    """Random windowed dependency graphs as ``(adj [B, V, VW] uint32,
    committed [B, V] bool, active [B, V] bool)``: a sparse digraph, a
    directed cycle through the first six vertices (multi-vertex SCCs), and
    GARBAGE in the padding lanes past ``V``, which must not reach the
    result. ``case``: ``"all_committed"`` (every vertex committed),
    ``"empty"`` (no vertex active), ``"one_cycle"`` (every active vertex
    on one directed cycle: one SCC), ``"long_path"`` (every vertex active,
    each depending on the one before it, a few uncommitted: the longest
    path a window holds, the most rounds of squaring)."""
    ids = np.arange(V)
    bits = rng.random((B, V, V)) < density
    ring = (ids[None, :] == (ids[:, None] + 1) % 6) & (ids[:, None] < 6)
    if case == "one_cycle":
        bits = np.broadcast_to(ids[None, :] == (ids[:, None] + 1) % V, (B, V, V))
        ring = np.zeros((V, V), bool)
    elif case == "long_path":
        bits = np.broadcast_to(ids[None, :] == ids[:, None] - 1, (B, V, V))
        ring = np.zeros((V, V), bool)
    adj = _np_pack(bits | ring[None])
    valid = _np_pack(np.ones((V,), bool))
    junk = rng.integers(0, 2**32, adj.shape, dtype=np.uint64).astype(np.uint32)
    adj = adj | (junk & ~valid)
    committed = rng.random((B, V)) < 0.45
    active = rng.random((B, V)) < 0.8
    if case == "all_committed":
        committed = np.ones((B, V), bool)
    elif case == "empty":
        active = np.zeros((B, V), bool)
    elif case == "one_cycle":
        active = np.ones((B, V), bool)
        committed = rng.random((B, V)) < 0.97
    elif case == "long_path":
        active = np.ones((B, V), bool)
        committed = np.ones((B, V), bool)
        for b in range(B):
            committed[b, rng.choice(V, size=max(1, V // 20), replace=False)] = False
    return adj, committed, active


def _np_pack(b: np.ndarray) -> np.ndarray:
    """numpy :func:`pack_mask`: [..., n] bool -> [..., VW] uint32."""
    n = b.shape[-1]
    nw = num_words(n)
    b = np.concatenate([b, np.zeros(b.shape[:-1] + (nw * _LANES - n,), bool)], -1)
    lanes = np.uint64(1) << np.arange(_LANES, dtype=np.uint64)
    words = b.reshape(b.shape[:-1] + (nw, _LANES)).astype(np.uint64)
    return (words * lanes).sum(-1).astype(np.uint32)


registry.register(
    registry.Plane(
        name=_PLANE,
        backend="bpaxos",
        reference=reference_depgraph_execute,
        kernel=fused_depgraph_execute,
        source=_SOURCE,
        replaces="frankenpaxos_tpu/ops/depgraph.py:282 fused_depgraph_execute "
        "(pallas_call :316)",
    )
)
