"""The CRAQ chain plane: its plain PyTorch version and the wrapper of its
hand-written CUDA kernel (``csrc/craq.cu``).

One plane of ``tpu/craq_batched.py`` dispatches here: ``craq_chain``
(:func:`fused_craq_chain`, replaces the Pallas ``fused_craq_chain`` at
``frankenpaxos_tpu/ops/craq.py:252``). It covers tick steps 1-2 of the
chain: DOWN writes arriving at mid-chain nodes join their pending sets
and forward, the tail applies, replies and starts the ack, UP acks apply
locally, leave the pending set and keep propagating, and the head's ack
retires the ring slot (ChainNode.scala:120-299).

The write ring is ``[N, W]`` (``N`` chains, ``W`` in-flight writes each);
the per-node state is two ``[N, L*KV]`` planes (pending-write counts and
applied versions, node ``l``'s key ``k`` at column ``l*KV + k``). Under a
partitioned plan every hop INTO a cut-side node while the cut is live
arrives at ``max(arrival, heal)``, or never (INF = 2**30) when the cut
never heals (``faults.defer_to_heal``); ``side`` carries the plan's side
bits over the ``L`` nodes.

:func:`reference_craq_chain` is the plain version, step for step the JAX
reference twin, with its outputs and dtypes. Two edges of the input
domain, which no State reaches, follow the JAX Pallas kernel: a node-slot
column outside ``[0, L*KV)`` is dropped (the JAX reference wraps a
negative one), and a hop target outside ``[0, L)`` is never on the cut
side. Node versions are at least -1 in every State (they start at -1 and
only grow by max); below -1 the JAX reference and its Pallas kernel
already part ways, and so may these two. The wrapper runs the plain
version when its tensors lie on the CPU and launches the kernel when they
lie on the card; it never falls back from the card to the plain version.

The kernel has two routes (:func:`craq_chain_route`): the vector route,
which every configuration of the repo takes (a CTA of whole chains, every
load issued before any store, the rows' updates in shared memory), and
the general kernel for the shapes it does not take.

Bound: bytes. The kernel writes new node planes (the caller's are never
updated in place), so it reads and writes ``8 * L * KV`` bytes a chain,
plus what the write slots need (:func:`craq_chain_needed_bytes`): 11.37
MB of the 11.8 MB all inputs and outputs hold (3.4 us at 3.35 TB/s) at
the main shape ``(N, W, L*KV) = (2500, 16, 256)`` on its seed-7 example
inputs.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from frankenpaxos_tpu_torch.ops import registry
from frankenpaxos_tpu_torch.ops.registry import on_cpu
from frankenpaxos_tpu_torch.tpu.common import INF

# Mirrors of the backend's write-slot codes (ops must not import the
# backend: the backend imports ops).
W_EMPTY = 0
W_DOWN = 1
W_UP = 2

_SOURCE = "frankenpaxos_tpu_torch/csrc/craq.cu"
_PLANE = "craq_chain"

CRAQ_CHAIN_OUTS = (
    "w_status", "w_node", "w_arrival", "node_dirty", "node_version",
    "at_tail", "wlat",
)


# ---------------------------------------------------------------------------
# Plain version (the specification the kernel is held against)
# ---------------------------------------------------------------------------


def _live(side, partition_start: int, partition_heal: int, t: int) -> bool:
    """Whether the plan's cut is live at tick ``t``."""
    return bool(side) and any(side) and t >= partition_start and (
        partition_heal < 0 or t < partition_heal
    )


def _hop_fn(side, partition_start: int, partition_heal: int, t: int, device):
    """The partition hop-deferral closure (``faults.defer_to_heal``
    semantics): arrivals at cut-side nodes while the cut is live wait for
    the heal tick. Identity without side bits or outside the cut."""
    if not _live(side, partition_start, partition_heal, t):
        return lambda arrival, node: arrival
    heal = partition_heal if partition_heal >= 0 else INF
    L = len(side)
    sides = torch.tensor(side, dtype=torch.int32, device=device)

    def hop(arrival, node):
        inside = (node >= 0) & (node < L)
        cut = inside & (sides[torch.clamp(node, 0, L - 1).long()] == 1)
        return torch.where(cut, torch.clamp_min(arrival, heal), arrival)

    return hop


def _scatter(plane, col, vals, reduce: str):
    """``plane.at[rows, col].add / .max(vals)`` with columns outside
    ``[0, LKV)`` dropped (they land in a spill column cut off after)."""
    N, LKV = plane.shape
    col = torch.where((col >= 0) & (col < LKV), col, LKV).long()
    padded = torch.cat([plane, plane.new_zeros((N, 1))], dim=1)
    if reduce == "add":
        padded = padded.scatter_add(1, col, vals)
    else:
        padded = padded.scatter_reduce(1, col, vals, "amax", include_self=True)
    return padded[:, :LKV]


def reference_craq_chain(
    w_status,  # [N, W] int8
    w_key,  # [N, W] int32
    w_version,  # [N, W] int32
    w_node,  # [N, W] int32
    w_arrival,  # [N, W] int32 absolute ticks
    w_issue,  # [N, W] int32
    node_dirty_flat,  # [N, L*KV] int32
    node_version_flat,  # [N, L*KV] int32
    hop_lat,  # [N, W] int32
    t,  # current tick (int)
    *,
    tail: int,
    num_keys: int,
    side: tuple = (),
    partition_start: int = 0,
    partition_heal: int = -1,
):
    """Tick steps 1-2 of craq_batched. Returns ``(w_status', w_node',
    w_arrival', node_dirty', node_version', at_tail, wlat)``: ``at_tail``
    [N, W] bool marks the tail applies (client-visible write completions)
    and ``wlat`` [N, W] int32 their latencies."""
    t = int(t)
    KV = num_keys
    hop = _hop_fn(side, partition_start, partition_heal, t, w_status.device)

    # DOWN arrivals (ChainNode._process_write_batch).
    arrive_down = (w_status == W_DOWN) & (w_arrival == t)
    at_mid = arrive_down & (w_node < tail)
    at_tail = arrive_down & (w_node == tail)
    wslot = w_node * KV + w_key
    node_dirty_flat = _scatter(
        node_dirty_flat, wslot, at_mid.to(torch.int32), "add"
    )
    node_version_flat = _scatter(
        node_version_flat, wslot, torch.where(at_tail, w_version, -1), "max"
    )
    wlat = torch.where(at_tail, t + hop_lat - w_issue, 0)
    w_node = torch.where(at_mid, w_node + 1, w_node)
    w_node = torch.where(at_tail, tail - 1, w_node)
    w_status = torch.where(at_tail, torch.full_like(w_status, W_UP), w_status)
    w_arrival = torch.where(arrive_down, hop(t + hop_lat, w_node), w_arrival)

    # UP (ack) arrivals (ChainNode._handle_ack).
    arrive_up = (w_status == W_UP) & (w_arrival == t)
    uslot = w_node * KV + w_key
    node_version_flat = _scatter(
        node_version_flat, uslot, torch.where(arrive_up, w_version, -1), "max"
    )
    node_dirty_flat = _scatter(
        node_dirty_flat, uslot, -arrive_up.to(torch.int32), "add"
    )
    retire = arrive_up & (w_node == 0)
    w_status = torch.where(retire, torch.full_like(w_status, W_EMPTY), w_status)
    w_arrival = torch.where(retire, INF, w_arrival)
    keep_up = arrive_up & ~retire
    w_node = torch.where(keep_up, w_node - 1, w_node)
    w_arrival = torch.where(keep_up, hop(t + hop_lat, w_node), w_arrival)
    return (
        w_status, w_node, w_arrival, node_dirty_flat, node_version_flat,
        at_tail, wlat,
    )


def craq_chain_needed_bytes(args, **statics) -> int:
    """The bytes :func:`reference_craq_chain` must move on these inputs
    (``args``: its positional arguments, ``t`` last; ``statics``: its
    keywords): the two node planes in and out; of each write slot its
    status, arrival, node and hop latency, its key only where a write or
    an ack arrives, its version where the tail applies or an ack arrives,
    its issue tick only where the tail applies; the side bits while a cut
    is live; and every output once."""
    (w_status, _, _, w_node, w_arrival, _, dirty, _, hop_lat, t) = args
    t = int(t)
    tail = statics["tail"]
    N, W = w_status.shape
    hop = _hop_fn(
        statics.get("side", ()), statics.get("partition_start", 0),
        statics.get("partition_heal", -1), t, w_status.device,
    )
    arrive_down = (w_status == W_DOWN) & (w_arrival == t)
    at_tail = arrive_down & (w_node == tail)
    at_mid = arrive_down & (w_node < tail)
    node1 = torch.where(at_tail, tail - 1, torch.where(at_mid, w_node + 1, w_node))
    status1 = torch.where(at_tail, torch.full_like(w_status, W_UP), w_status)
    arrival1 = torch.where(arrive_down, hop(t + hop_lat, node1), w_arrival)
    arrive_up = (status1 == W_UP) & (arrival1 == t)
    n_key = int((arrive_down | arrive_up).sum())
    n_version = int((at_tail | arrive_up).sum())
    n_issue = int(at_tail.sum())
    side = statics.get("side", ())
    live = _live(side, statics.get("partition_start", 0),
                 statics.get("partition_heal", -1), t)
    return (
        4 * dirty.numel() * 4  # the node planes in and out
        + N * W * 13 + 4 * (n_key + n_version + n_issue)
        + (len(side) if live else 0)
        + N * W * 14  # the write-slot outputs
    )


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# Pointer slots of the kernel's argument block, in the order of the `Slot`
# enum of csrc/craq.cu.
_PTR_SLOTS = (
    "ws", "wk", "wv", "wn", "wa", "wi", "dirty", "ver", "lat", "side",
    "o_ws", "o_wn", "o_wa", "o_dirty", "o_ver", "o_at_tail", "o_wlat",
)
_IN_SPECS = {  # slot: (shape kind, dtype)
    "ws": ("nw", torch.int8), "wk": ("nw", torch.int32),
    "wv": ("nw", torch.int32), "wn": ("nw", torch.int32),
    "wa": ("nw", torch.int32), "wi": ("nw", torch.int32),
    "dirty": ("nk", torch.int32), "ver": ("nk", torch.int32),
    "lat": ("nw", torch.int32),
}


# The vector route's limits (csrc/craq.cu): the shared memory of its CTA
# (two node rows a chain, kVecSharedBytes) and the 16-byte vectors of each
# node plane a thread holds at most (kRowVecs); and the least threads of
# its CTA, a warp. Its launch shape fills a thread's vectors where the
# ring allows (a chip race chose it: harness/chain_race.py).
VEC_SHARED_BYTES = 48 * 1024
VEC_ROW_VECS = 4
VEC_THREADS = 32


def chain_launch_shape(W: int, LKV: int, block: int = 0) -> tuple:
    """``(chains a CTA, threads a CTA)`` of the vector route for a ring of
    ``W`` slots and rows of ``LKV`` columns: a chain takes a thread for
    each of its slots and for each :data:`VEC_ROW_VECS` 16-byte vectors of
    each node row, ``block`` threads (else at least :data:`VEC_THREADS`, a
    whole number of warps, at most 1024) take as many chains as fit, and
    the chains' rows fit :data:`VEC_SHARED_BYTES`."""
    lanes = max(W, -(-LKV // (4 * VEC_ROW_VECS)), 1)
    threads = block or min(1024, max(VEC_THREADS, -(-lanes // 32) * 32))
    cpb = max(1, min(threads // lanes, VEC_SHARED_BYTES // max(1, 8 * LKV)))
    return cpb, threads


def craq_chain_route(*args, block: int = 0) -> str:
    """The chain kernel's route for the plane's arguments (those of
    :func:`fused_craq_chain`): "vector" when L*KV % 4 == 0, the CTA of
    :func:`chain_launch_shape` holds a thread for each of its write slots
    and its chains' rows in registers and shared memory, and the node
    planes are 16-byte aligned; else "general" (any shape). The kernel
    refuses the vector route where its conditions do not hold."""
    W, LKV = args[0].shape[1], args[6].shape[1]
    cpb, threads = chain_launch_shape(W, LKV, block)
    if (
        LKV % 4 == 0
        and cpb * W <= threads
        and cpb * (LKV // 4) <= threads * VEC_ROW_VECS
        and 8 * cpb * LKV <= VEC_SHARED_BYTES
        and registry.aligned16(args[6:8])
    ):
        return "vector"
    return "general"


@functools.lru_cache(maxsize=16)
def _side_bits(side: tuple, device: torch.device) -> torch.Tensor:
    """The plan's side bits as a device constant (made once per plan)."""
    return torch.tensor(side, dtype=torch.int8, device=device)


def _craq_chain_kernel(
    w_status, w_key, w_version, w_node, w_arrival, w_issue,
    node_dirty_flat, node_version_flat, hop_lat, t, block: int = 0, *,
    tail: int, num_keys: int, side: tuple = (), partition_start: int = 0,
    partition_heal: int = -1,
):
    """Check the tensors, pick the route (:func:`craq_chain_route`),
    allocate the outputs and pack the launch; returns ``(launch,
    outputs)``. The launch loads the CUDA library, so the checks run
    without a card; it carries ``route`` and ``packed``, the library
    call's arguments (``harness/chain_race.py`` calls other builds of the
    source with them)."""
    from frankenpaxos_tpu_torch.ops import _build

    N, W = w_status.shape
    LKV = node_dirty_flat.shape[1] if node_dirty_flat.dim() == 2 else -1
    ins = dict(
        ws=w_status, wk=w_key, wv=w_version, wn=w_node, wa=w_arrival,
        wi=w_issue, dirty=node_dirty_flat, ver=node_version_flat, lat=hop_lat,
    )
    shapes = {"nw": (N, W), "nk": (N, LKV)}
    for slot, x in ins.items():
        kind, dtype = _IN_SPECS[slot]
        if tuple(x.shape) != shapes[kind]:
            raise ValueError(
                f"{_PLANE}: {slot} has shape {tuple(x.shape)}, want "
                f"{shapes[kind]}"
            )
        if x.dtype != dtype:
            raise TypeError(f"{_PLANE}: {slot} has dtype {x.dtype}, want {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{_PLANE}: {slot} is not contiguous")
    t = int(t)
    if not -(2**31) <= t < 2**31:
        raise ValueError(f"{_PLANE}: tick {t} outside int32")
    if not 1 <= tail < 2**31 or not 1 <= num_keys < 2**31:
        raise ValueError(f"{_PLANE}: tail {tail} / num_keys {num_keys}")
    if block and (not 32 <= block <= 1024 or block % 32):
        raise ValueError(
            f"{_PLANE}: block={block} threads, want a multiple of 32 in "
            f"32-1024"
        )
    route = craq_chain_route(*ins.values(), block=block)
    cpb, threads = chain_launch_shape(W, LKV, block)
    if route == "general":  # cpb = threads / W, the kernel's own choice
        cpb, threads = 0, block or 256
    dev = w_status.device
    live = _live(side, partition_start, partition_heal, t)
    heal = partition_heal if partition_heal >= 0 else INF
    ins["side"] = _side_bits(tuple(side), dev) if live else None
    num_sides = len(side) if live else 0

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = dict(
        o_ws=empty((N, W), torch.int8),
        o_wn=empty((N, W), torch.int32),
        o_wa=empty((N, W), torch.int32),
        o_dirty=empty((N, LKV), torch.int32),
        o_ver=empty((N, LKV), torch.int32),
        o_at_tail=empty((N, W), torch.bool),
        o_wlat=empty((N, W), torch.int32),
    )
    tensors = {**ins, **outs}
    ptrs = (ctypes.c_void_p * len(_PTR_SLOTS))(
        *[
            None if tensors[s] is None else tensors[s].data_ptr()
            for s in _PTR_SLOTS
        ]
    )
    ints = (ctypes.c_int * 11)(
        N, W, LKV, num_keys, tail, t, num_sides, heal, threads,
        registry.ROUTES.index(route), cpb,
    )

    def launch() -> None:
        lib = _build.kernel_lib("fpx_craq", len(_PTR_SLOTS))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fpx_craq_launch(ptrs, ints, stream)
        if err != 0:
            raise RuntimeError(
                f"{_PLANE}: kernel launch failed: "
                f"{lib.fpx_error_string(err).decode()} (cuda error {err})"
            )
        registry.count_launch(_PLANE, route)

    launch.route = route
    launch.packed = (ptrs, ints)
    order = ("o_ws", "o_wn", "o_wa", "o_dirty", "o_ver", "o_at_tail", "o_wlat")
    return launch, tuple(outs[k] for k in order)


def fused_craq_chain(
    w_status, w_key, w_version, w_node, w_arrival, w_issue,
    node_dirty_flat, node_version_flat, hop_lat, t, block: int = 0, *,
    tail: int = 1, num_keys: int = 1, side: tuple = (),
    partition_start: int = 0, partition_heal: int = -1,
):
    """:func:`reference_craq_chain` as one CUDA kernel on the card (the
    plain version on the CPU). Replaces the Pallas ``fused_craq_chain``
    (frankenpaxos_tpu/ops/craq.py:252), on the route of
    :func:`craq_chain_route`. Bound by bytes: the new node planes, 11.4 MB
    needed at (2500, 16, 256). Bit-exact: integer adds and maxes into the
    chain's node row, which commute, and the ring arithmetic in wrapping
    int32."""
    args = (
        w_status, w_key, w_version, w_node, w_arrival, w_issue,
        node_dirty_flat, node_version_flat, hop_lat,
    )
    statics = dict(
        tail=tail, num_keys=num_keys, side=tuple(side),
        partition_start=partition_start, partition_heal=partition_heal,
    )
    if on_cpu(args):
        return reference_craq_chain(*args, t, **statics)
    launch, out = _craq_chain_kernel(*args, t, block, **statics)
    launch()
    return out


def prepared_launch(*args, **statics) -> tuple:
    """For timing the kernel apart from its wrapper: checks the tensors
    ``args`` (the wrapper's arguments), picks the route, allocates the
    outputs and returns ``(launch, outputs)``; each ``launch()`` runs the
    kernel once into those outputs (and counts as a launch on its route,
    ``launch.route``). On CPU tensors it runs the wrapper's checks alone:
    only the launch needs the card."""
    return _craq_chain_kernel(*args, **statics)


# ---------------------------------------------------------------------------
# Example inputs: numpy arrays in the State's dtype policy, from a seed.
# ---------------------------------------------------------------------------

EDGE_CASES = ("random", "all_arrive", "out_of_range", "zero_latency")


def example_craq_chain_args(rng, N, W, L, KV, t=40, case="random"):
    """Inputs of the plane at ``(N, W)`` writes over ``L`` nodes of ``KV``
    keys (``t`` last). Live writes sit at nodes of their direction's range
    with arrivals around ``t``; node versions are at least -1, as in every
    State. ``case``:

    * ``"random"``: a mix of empty, DOWN and UP slots;
    * ``"all_arrive"``: every slot live and arriving now, so several
      writes of a chain hit the same node slot in one call;
    * ``"out_of_range"``: some keys put the node-slot column past
      ``L*KV`` or below ``-L*KV`` (the kernel drops those updates);
    * ``"zero_latency"``: zero hop latencies, so a tail apply's ack and a
      forwarded write also arrive this tick.
    """
    i32 = np.int32
    tail = L - 1
    status = rng.integers(0, 3, (N, W))
    arrival = t + rng.integers(-1, 3, (N, W))
    if case == "all_arrive":
        status = rng.integers(1, 3, (N, W))
        arrival = np.full((N, W), t)
    arrival = np.where(status == W_EMPTY, INF, arrival)
    node = np.where(
        status == W_DOWN, rng.integers(0, L, (N, W)), rng.integers(0, tail, (N, W))
    )
    key = rng.integers(0, KV, (N, W))
    if case == "all_arrive":
        key = rng.integers(0, min(KV, 2), (N, W))
    if case == "out_of_range":
        far = rng.random((N, W)) < 0.3
        key = np.where(far, rng.choice([L * KV, 5 * L * KV, -3 * L * KV], (N, W)), key)
    version = np.where(status == W_EMPTY, -1, rng.integers(0, 500, (N, W)))
    issue = np.where(status == W_EMPTY, INF, t - rng.integers(0, 20, (N, W)))
    dirty = rng.integers(0, 3, (N, L * KV))
    ver = rng.integers(-1, 400, (N, L * KV))
    lat = rng.integers(1, 4, (N, W))
    if case == "zero_latency":
        lat = np.where(rng.random((N, W)) < 0.7, 0, lat)
    return (
        status.astype(np.int8), key.astype(i32), version.astype(i32),
        node.astype(i32), arrival.astype(i32), issue.astype(i32),
        dirty.astype(i32), ver.astype(i32), lat.astype(i32), t,
    )


registry.register(
    registry.Plane(
        name=_PLANE,
        backend="craq",
        reference=reference_craq_chain,
        kernel=fused_craq_chain,
        source=_SOURCE,
        replaces="frankenpaxos_tpu/ops/craq.py:252 fused_craq_chain "
        "(pallas_call :309)",
    )
)
