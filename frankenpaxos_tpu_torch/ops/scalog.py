"""The Scalog cut-commit plane: its plain PyTorch version and the wrapper
of its hand-written CUDA kernel (``csrc/scalog.cu``).

One plane of ``tpu/scalog_batched.py`` dispatches here:
``scalog_cut_commit`` (:func:`fused_scalog_cut_commit`, replaces the
Pallas ``fused_scalog_cut_commit`` at
``frankenpaxos_tpu/ops/scalog.py:184``). It covers tick step 2: the
in-order commit scan over the in-flight cut ring (a cut commits only once
every earlier cut has: the running max over issue order models the Paxos
log of cuts), the newest committed cut's projection onto the global log,
each committing cut's record count and ordering lag (its records waited
from ITS OWN snapshot, so head-of-line blocking stays visible), and the
ring-slot frees.

The ring is ``[P, S]``: ``P`` in-flight cuts (the pipeline depth
``max_inflight_cuts``) of ``S`` per-shard log lengths. ``committed_cuts``
and ``next_cut`` are 0-d int32 tensors (device values of the State, so
the tick never waits for the card).

:func:`reference_scalog_cut_commit` is the plain version, line for line
the JAX reference twin, with its outputs and dtypes. The wrapper runs it
when its tensors lie on the CPU and launches the kernel when they lie on
the card; it never falls back from the card to the plain version.

Bound: bytes. The function needs the ring rows of the committing cuts
only, plus ``last_committed_cut``, and writes the new cut: under 1 MB even
at 10,000 shards, so it sits at launch latency. The kernel has two routes,
chosen by :func:`scalog_cut_commit_route`: the cluster route (one launch of
one thread-block cluster, every load in one trip, no memset), which the
main path takes, and the general route (a memset of ``recs``, then a grid
over shards), which a pipeline deeper than 16 cuts or more shards than
the cluster beat it at take.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from frankenpaxos_tpu_torch.ops import registry
from frankenpaxos_tpu_torch.ops.registry import on_cpu
from frankenpaxos_tpu_torch.tpu.common import INF, sum32

_SOURCE = "frankenpaxos_tpu_torch/csrc/scalog.cu"
_PLANE = "scalog_cut_commit"

SCALOG_CUT_COMMIT_OUTS = (
    "new_cut", "committed_now", "recs", "lag", "slot_committed",
    "cut_commit_tick", "cut_snap_tick",
)


# ---------------------------------------------------------------------------
# Plain version (the specification the kernel is held against)
# ---------------------------------------------------------------------------


def reference_scalog_cut_commit(
    cut_vec,  # [P, S] int32 in-flight cut vectors
    cut_commit_tick,  # [P] int32 commit tick per ring slot (INF)
    cut_snap_tick,  # [P] int32 snapshot tick per ring slot
    cut_prev_snap,  # [P] int32 the PREVIOUS cut's snapshot tick
    last_committed_cut,  # [S] int32
    committed_cuts,  # [] int32 cuts committed so far
    next_cut,  # [] int32 cuts issued so far
    t,  # current tick (int)
):
    """Tick step 2 of scalog_batched. Returns ``(new_cut [S],
    committed_now [P] bool (issue order), recs [P] int32, lag [P] int32,
    slot_committed [P] bool (ring order), cut_commit_tick' [P],
    cut_snap_tick' [P])``."""
    P = cut_vec.shape[0]
    dev = cut_vec.device
    ids = committed_cuts + torch.arange(P, dtype=torch.int32, device=dev)
    live = ids < next_cut
    slots = (ids % P).long()  # floor mod
    ticks = torch.where(live, cut_commit_tick[slots], INF)
    eff = torch.cummax(ticks, dim=0).values
    committed_now = live & (eff <= t)
    n_new = sum32(committed_now)

    newest_slot = slots[torch.clamp(n_new - 1, 0, P - 1).long()]
    new_cut = torch.where(n_new > 0, cut_vec[newest_slot], last_committed_cut)

    vec = cut_vec[slots]  # [P, S] in issue order
    prev_vec = torch.cat([last_committed_cut[None, :], vec[:-1]], dim=0)
    recs = torch.where(committed_now, sum32(vec - prev_vec, dim=1), 0)
    snap = cut_snap_tick[slots]
    snap_wait = torch.div(
        snap - cut_prev_snap[slots] + 1, 2, rounding_mode="floor"
    )
    lag = torch.where(committed_now, (t - snap) + snap_wait, 0)

    slot_committed = torch.zeros(P, dtype=torch.bool, device=dev).scatter(
        0, slots, committed_now
    )
    new_commit_tick = torch.where(slot_committed, INF, cut_commit_tick)
    new_snap_tick = torch.where(slot_committed, INF, cut_snap_tick)
    return (
        new_cut, committed_now, recs, lag, slot_committed,
        new_commit_tick, new_snap_tick,
    )


def scalog_cut_commit_needed_bytes(*args) -> int:
    """The bytes :func:`reference_scalog_cut_commit` must move on these
    inputs (its arguments, ``t`` last): ``last_committed_cut`` in and
    ``new_cut`` out (8 B a shard), the committing cuts' rows (4 B a shard
    each), about 30 B a ring slot and the two counters."""
    P, S = args[0].shape
    n_commit = int(reference_scalog_cut_commit(*args)[1].sum())
    return S * 8 + n_commit * S * 4 + P * 30 + 8


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# Pointer slots of the kernel's argument block, in the order of the `Slot`
# enum of csrc/scalog.cu.
_PTR_SLOTS = (
    "vec", "commit", "snap", "prev", "last", "cc", "nc",
    "o_cut", "o_committed", "o_recs", "o_lag", "o_slotc", "o_commit",
    "o_snap",
)
_IN_SPECS = {  # slot: (shape kind, dtype)
    "vec": ("ps", torch.int32), "commit": ("p", torch.int32),
    "snap": ("p", torch.int32), "prev": ("p", torch.int32),
    "last": ("s", torch.int32), "cc": ("0", torch.int32),
    "nc": ("0", torch.int32),
}


# Cuts in flight that the cluster route's threads hold in registers:
# kClusterMaxP of csrc/scalog.cu, whose launcher refuses the route past it.
CLUSTER_MAX_P = 16
# The most shards the wrapper gives the cluster route: where it last beat
# the general route (cold, NVIDIA H100 80GB HBM3 at 700 W,
# harness/chain_race.py; PERF.md): at (P, S) = (8, 12000) and (16, 8192),
# not at (8, 16384), nor at 32 cuts (2,500 and 4,096 shards).
CLUSTER_ROUTE_MAX_SHARDS = 12000


def cluster_max_shards(P: int) -> int:
    """The most shards the cluster route can take with ``P`` cuts in
    flight, 0 for a ``P`` it cannot take: one trip of the whole cluster (8
    CTAs of 1024 or 512 threads for P up to 8 or 16, 2 shards a thread).
    It mirrors csrc/scalog.cu ``fpx_scalog_cluster_max_shards``, because
    the route is chosen without a card; ``chip_smoke.py`` holds the two
    against each other for every P."""
    if not 1 <= P <= CLUSTER_MAX_P:
        return 0
    return 8 * (1024 if P <= 8 else 512) * 2


def scalog_cut_commit_route(cut_vec, *args) -> str:
    """The cut-commit kernel's route for the plane's tensors (the
    arguments of :func:`fused_scalog_cut_commit`, ``t`` left out); the one
    place that decides it: "cluster" (one launch, every load in one trip)
    when the cluster can take the shape (:func:`cluster_max_shards`) and
    at most :data:`CLUSTER_ROUTE_MAX_SHARDS` shards, else "general" (a
    memset and a grid over shards, the ring walk in shared memory), which
    spreads a wider ring over every SM. The kernel's launcher refuses the
    cluster route where the cluster cannot take the shape."""
    P, S = cut_vec.shape
    if P <= CLUSTER_MAX_P and S <= min(cluster_max_shards(P),
                                       CLUSTER_ROUTE_MAX_SHARDS):
        return "cluster"
    return "general"


def _scalog_cut_commit_kernel(
    cut_vec, cut_commit_tick, cut_snap_tick, cut_prev_snap,
    last_committed_cut, committed_cuts, next_cut, t, block: int = 0,
):
    """Check the tensors, allocate the outputs and pack the launch;
    returns ``(launch, outputs)``. The launch loads the CUDA library, so
    the checks run without a card. ``block``: threads a CTA of the
    general route (0: 256); the cluster route sizes its own."""
    from frankenpaxos_tpu_torch.ops import _build

    P, S = cut_vec.shape
    if P < 1:
        raise ValueError(f"{_PLANE}: pipeline depth {P} < 1")
    ins = dict(
        vec=cut_vec, commit=cut_commit_tick, snap=cut_snap_tick,
        prev=cut_prev_snap, last=last_committed_cut, cc=committed_cuts,
        nc=next_cut,
    )
    shapes = {"ps": (P, S), "p": (P,), "s": (S,), "0": ()}
    for slot, x in ins.items():
        kind, dtype = _IN_SPECS[slot]
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{_PLANE}: {slot} must be a tensor on the card")
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
    threads = block if block > 0 else 256
    if not 32 <= threads <= 1024 or threads % 32:
        raise ValueError(
            f"{_PLANE}: block={threads} threads, want a multiple of 32 in "
            f"32-1024"
        )

    dev = cut_vec.device

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    route = scalog_cut_commit_route(cut_vec)
    outs = dict(
        o_cut=empty((S,), torch.int32),
        o_committed=empty((P,), torch.bool),
        o_recs=empty((P,), torch.int32),  # written once a launch
        o_lag=empty((P,), torch.int32),
        o_slotc=empty((P,), torch.bool),
        o_commit=empty((P,), torch.int32),
        o_snap=empty((P,), torch.int32),
    )
    tensors = {**ins, **outs}
    ptrs = (ctypes.c_void_p * len(_PTR_SLOTS))(
        *[tensors[s].data_ptr() for s in _PTR_SLOTS]
    )
    # The general route's threads come before the route code, so a build
    # that knows only the general route reads the same list.
    ints = (ctypes.c_int * 5)(P, S, t, threads, registry.ROUTES.index(route))

    def call(entry: str, what: str) -> None:
        lib = _build.kernel_lib("fpx_scalog", len(_PTR_SLOTS))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(ptrs, ints, stream)
        if err != 0:
            raise RuntimeError(
                f"{_PLANE}: {what} launch failed: "
                f"{lib.fpx_error_string(err).decode()} (cuda error {err})"
            )

    def launch() -> None:
        call("fpx_scalog_launch", "kernel")
        registry.count_launch(_PLANE, route)

    # The launch floors (csrc/scalog.cu), not launches of the kernel, so
    # not counted: the general route's memset and grid with a kernel that
    # does nothing, and the route's own launch shape with one (no memset).
    launch.floor = lambda: call("fpx_scalog_floor_launch", "floor")
    launch.floor_one = lambda: call("fpx_scalog_one_floor_launch", "one-launch floor")
    launch.route = route
    launch.packed = (ptrs, ints)
    order = ("o_cut", "o_committed", "o_recs", "o_lag", "o_slotc",
             "o_commit", "o_snap")
    return launch, tuple(outs[k] for k in order)


def fused_scalog_cut_commit(
    cut_vec, cut_commit_tick, cut_snap_tick, cut_prev_snap,
    last_committed_cut, committed_cuts, next_cut, t, block: int = 0,
):
    """:func:`reference_scalog_cut_commit` as one CUDA kernel on the card
    (the plain version on the CPU). Replaces the Pallas
    ``fused_scalog_cut_commit`` (frankenpaxos_tpu/ops/scalog.py:184).
    Bit-exact: the per-cut record counts add in wrapping int32 (integer
    adds, whose sum does not depend on their order), the snapshot wait
    is a floor division."""
    args = (
        cut_vec, cut_commit_tick, cut_snap_tick, cut_prev_snap,
        last_committed_cut, committed_cuts, next_cut,
    )
    if on_cpu([a for a in args if isinstance(a, torch.Tensor)]):
        return reference_scalog_cut_commit(*args, t)
    launch, out = _scalog_cut_commit_kernel(*args, t, block)
    launch()
    return out


def prepared_launch(*args, **statics) -> tuple:
    """For timing the kernel apart from its wrapper: checks the tensors
    ``args`` (the wrapper's arguments), allocates the outputs and returns
    ``(launch, outputs)``; each ``launch()`` runs the kernel once into
    those outputs (and counts as a launch). ``launch.floor()`` runs the
    general route's floor on the same arguments (its memset and grid with
    a kernel that does nothing), ``launch.floor_one()`` the route's own
    launch shape with a kernel that does nothing and no memset (neither
    counted); ``launch.route`` is the route. On CPU tensors it runs the
    wrapper's checks alone: only the launch needs the card."""
    return _scalog_cut_commit_kernel(*args, **statics)


# ---------------------------------------------------------------------------
# Example inputs: numpy arrays in the State's dtype policy, from a seed.
# ---------------------------------------------------------------------------

EDGE_CASES = ("random", "none_live", "all_committed", "gap", "wrap")


def example_scalog_cut_commit_args(rng, P, S, t=40, case="random"):
    """Inputs of the plane at ``(P, S)`` (``t`` last; ``committed_cuts``
    and ``next_cut`` as 0-d int32 arrays). The live cuts' vectors grow
    monotonically in issue order from ``last_committed_cut``; their
    commit ticks lie around ``t``, their snapshot ticks before it (some
    previous-snapshot ticks later than the snapshot, so the floor division
    meets negative numbers). ``case``:

    * ``"random"``: a random number of live cuts; stale values in the
      dead ring slots;
    * ``"none_live"``: no cut in flight;
    * ``"all_committed"``: every ring slot live with its decision landed;
    * ``"gap"``: a live cut in the middle of the order still undecided
      while later ones have landed, so only the prefix commits;
    * ``"wrap"``: ``committed_cuts`` not a multiple of ``P``, every cut
      live and all but the newest decided, so the committed prefix wraps
      past ring slot ``P - 1``.
    """
    i32 = np.int32
    cc = int(rng.integers(0, 5 * P))
    n_live = int(rng.integers(0, P + 1))
    if case == "none_live":
        n_live = 0
    elif case in ("all_committed", "gap", "wrap"):
        n_live = P
    if case == "wrap":
        cc = 3 * P + 1 + int(rng.integers(0, max(1, P - 1)))
    order = np.arange(P)
    slots = (cc + order) % P
    last = rng.integers(0, 1000, S)
    vec_asc = last[None, :] + np.cumsum(rng.integers(0, 5, (P, S)), axis=0)
    cut_vec = np.empty((P, S), np.int64)
    cut_vec[slots] = vec_asc
    live = order < n_live
    commit_asc = t + rng.integers(-3, 4, P)
    if case == "all_committed":
        commit_asc = t - rng.integers(0, 4, P)
    elif case == "wrap":
        commit_asc = t - rng.integers(0, 4, P)
        commit_asc[P - 1] = t + 1
    elif case == "gap":
        commit_asc = t - rng.integers(0, 4, P)
        commit_asc[P // 2] = t + 2
    stale = np.where(rng.random(P) < 0.5, INF, t - 1)
    commit_asc = np.where(live, commit_asc, stale)
    snap_asc = t - 2 * (P - order) - rng.integers(0, 3, P)
    prev_asc = snap_asc - rng.integers(-3, 6, P)
    commit = np.empty(P, np.int64)
    snap = np.empty(P, np.int64)
    prev = np.empty(P, np.int64)
    commit[slots], snap[slots], prev[slots] = commit_asc, snap_asc, prev_asc
    return (
        cut_vec.astype(i32),
        commit.astype(i32),
        snap.astype(i32),
        prev.astype(i32),
        last.astype(i32),
        np.array(cc, i32),
        np.array(cc + n_live, i32),
        t,
    )


registry.register(
    registry.Plane(
        name=_PLANE,
        backend="scalog",
        reference=reference_scalog_cut_commit,
        kernel=fused_scalog_cut_commit,
        source=_SOURCE,
        replaces="frankenpaxos_tpu/ops/scalog.py:184 fused_scalog_cut_commit "
        "(pallas_call :247)",
    )
)
