"""The Fast MultiPaxos vote plane: its plain PyTorch version and the
wrapper of its hand-written CUDA kernel (``csrc/fastmultipaxos.cu``).

One plane of ``tpu/fastmultipaxos_batched.py`` dispatches here:
``fastmultipaxos_vote`` (:func:`fused_fmp_vote`, replaces the Pallas
``fused_fmp_vote`` at ``frankenpaxos_tpu/ops/fastmultipaxos.py:266``). It
covers tick steps 2-3:

* the leader's census of each slot: visible votes, pairwise same-value
  counts over the tiny acceptor axis, the first-max value among the
  visible votes (``best``) and among all votes (``full``);
* the fast-committed ledger: a value that ever held a fast quorum of
  votes, visible or not;
* the fast choose (a fast quorum of identical visible votes), or the
  start of classic recovery on a full census or a timed-out slot;
* the classic round's acceptor votes and its f+1 quorum;
* the chosen stamps (value, replica arrival) and the safety ledger.

:func:`reference_fmp_vote` is the plain version, line for line the JAX
reference twin, with its outputs and dtypes. The wrapper runs it when its
tensors lie on the CPU and launches the kernel when they lie on the card;
it never falls back from the card to the plain version.

The kernel has two routes (:func:`fmp_vote_route`): the scalar route,
which every A in 3-9 takes (a thread a slot, A in registers, every dense
load before any store, the latencies in a second trip only where they
are used), and the general kernel (the kernel as first written: a thread
a slot, loads interleaved with stores) for A outside 3-9, with A at run
time.

Bound: a few dozen integer ops per slot against ~120 B per slot, so
bound by the bytes moved. The bytes the function needs
(:func:`fmp_vote_needed_bytes`: no classic Phase2a where recovery
overwrites it, no classic Phase2b or vote bit where a classic Phase2a
lands now, no carried chosen value or replica arrival where the slot is
chosen now, each latency only where it is used; every output) are 13.0
MB at ``(A, G, W) = (3, 3334, 32)`` on the kernels line's inputs (3.9 us
at 3.35 TB/s). The scalar route reads every dense field
(:func:`fmp_vote_route_bytes`, 13.4 MB); every input and output once is
14.1 MB.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from frankenpaxos_tpu_torch.ops import registry
from frankenpaxos_tpu_torch.ops.registry import on_cpu
from frankenpaxos_tpu_torch.tpu.common import INF, sum32

# Mirrors of the backend's slot codes (ops must not import the backend:
# the backend imports ops).
S_OPEN = 0
S_RECOVER = 1
S_CHOSEN = 2
NO_VALUE = -1

_SOURCE = "frankenpaxos_tpu_torch/csrc/fastmultipaxos.cu"
_PLANE = "fastmultipaxos_vote"

FMP_VOTE_OUTS = (
    "status", "open_tick", "fast_committed", "rv_value",
    "rv_p2a_arrival", "rv_p2b_arrival", "rv_voted",
    "chosen_value", "replica_arrival",
    "newly_chosen", "fast_ok", "start_rec", "safety",
)


# ---------------------------------------------------------------------------
# Plain version (the specification the kernel is held against)
# ---------------------------------------------------------------------------


def _first_max(counts, values):
    """``(max over axis 0, values at jnp.argmax's first maximum)``."""
    best = torch.argmax(counts, dim=0)
    return (
        torch.amax(counts, dim=0),
        torch.gather(values, 0, best[None])[0],
    )


def reference_fmp_vote(
    vote_value,  # [A, G, W] int32 fast-round votes (NO_VALUE none)
    vote_seen,  # [A, G, W] int32 tick the leader sees the vote (INF)
    status,  # [G, W] int8 S_*
    open_tick,  # [G, W] int32 first visible vote tick (INF)
    fast_committed,  # [G, W] int32 ledger (NO_VALUE none)
    rv_value,  # [G, W] int32 classic-round proposal value
    rv_p2a_arrival,  # [A, G, W] int32
    rv_p2b_arrival,  # [A, G, W] int32
    rv_voted,  # [A, G, W] bool
    chosen_value,  # [G, W] int32
    replica_arrival,  # [G, W] int32
    rv_lat,  # [G, W] int32 classic-round hop latencies
    reply_lat,  # [G, W] int32 chosen -> replica latencies
    t,  # current tick (int)
    *,
    fq: int,
    f: int,
    recovery_timeout: int,
):
    """Tick steps 2-3 of fastmultipaxos_batched. Returns the updated slot
    and vote arrays plus the ``newly_chosen`` / ``fast_ok`` /
    ``start_rec`` / ``safety`` masks (:data:`FMP_VOTE_OUTS`)."""
    A = vote_value.shape[0]

    # 2. The leader observes the votes of each slot.
    visible = vote_seen <= t  # [A, G, W]
    n_visible = sum32(visible, dim=0)
    open_tick = torch.where(
        (open_tick == INF) & (n_visible > 0) & (status == S_OPEN),
        t,
        open_tick,
    )
    pair = (vote_value[:, None] == vote_value[None, :]) & (
        vote_value[None, :] != NO_VALUE
    )  # [A, A, G, W]
    match_count = sum32(pair & visible[:, None] & visible[None, :], dim=1)
    best_count, best_value = _first_max(match_count, vote_value)
    full_count, full_value = _first_max(sum32(pair, dim=1), vote_value)
    fast_committed = torch.where(
        (fast_committed == NO_VALUE) & (full_count >= fq),
        full_value,
        fast_committed,
    )

    fast_ok = (status == S_OPEN) & (best_count >= fq)
    census_full = n_visible >= A
    timed_out = (
        (open_tick < INF)
        & (t - open_tick >= recovery_timeout)
        & (n_visible >= A - f)
    )
    start_rec = (status == S_OPEN) & ~fast_ok & (census_full | timed_out)
    new_rv_value = torch.where(start_rec, best_value, rv_value)
    status = torch.where(start_rec, S_RECOVER, status)
    new_rv_p2a = torch.where(
        start_rec[None], (t + rv_lat)[None].expand_as(vote_value), rv_p2a_arrival
    )

    # 3. The classic round at the acceptors, and the choose.
    rv_now = new_rv_p2a == t
    new_rv_voted = rv_voted | rv_now
    new_rv_p2b = torch.where(rv_now, (t + rv_lat)[None], rv_p2b_arrival)
    new_rv_p2a = torch.where(rv_now, INF, new_rv_p2a)
    n_rv = sum32(new_rv_voted & (new_rv_p2b <= t), dim=0)
    rec_ok = (status == S_RECOVER) & (n_rv >= f + 1)

    newly_chosen = fast_ok | rec_ok
    # rec_ok slots were recovering before this tick, so the PRE-update
    # rv_value is the value their round proposed.
    value_now = torch.where(fast_ok, best_value, rv_value)
    safety = (
        newly_chosen
        & (fast_committed != NO_VALUE)
        & (value_now != fast_committed)
    )
    new_chosen_value = torch.where(newly_chosen, value_now, chosen_value)
    status = torch.where(newly_chosen, S_CHOSEN, status)
    new_replica_arrival = torch.where(
        newly_chosen, t + reply_lat, replica_arrival
    )
    return (
        status, open_tick, fast_committed, new_rv_value,
        new_rv_p2a, new_rv_p2b, new_rv_voted,
        new_chosen_value, new_replica_arrival,
        newly_chosen, fast_ok, start_rec, safety,
    )


def fmp_vote_needed_bytes(args, **statics) -> int:
    """The bytes the plain version's outputs need on these inputs
    (``args``: its positional arguments, ``t`` last; ``statics``: fq, f,
    recovery_timeout): every vote and seen tick; every slot's status,
    open tick, fast-committed value and classic value; a classic Phase2a
    tick where recovery does not start; a classic Phase2b tick and vote
    bit where no classic Phase2a lands now; the carried chosen value and
    replica arrival where the slot is not chosen now; the classic latency
    where recovery starts or a classic Phase2a lands now, the reply
    latency where the slot is chosen now; every output once. The outputs
    depend on no other input cell (the poison test of
    ``tests/test_torch_ops_fastmultipaxos.py``)."""
    A, G, W = args[0].shape
    cells, slots = A * G * W, G * W
    out = reference_fmp_vote(*args, **statics)
    start, newly = out[11], out[9]
    now = fmp_rv_now(args, start)
    n_start, n_now, n_new = int(start.sum()), int(now.sum()), int(newly.sum())
    return (
        cells * 8 + slots * 13  # votes, seen ticks; status, open, fc, rvv
        + 4 * A * (slots - n_start)  # classic Phase2a ticks
        + 5 * (cells - n_now)  # classic Phase2b ticks and vote bits
        + 8 * (slots - n_new)  # carried chosen values, replica arrivals
        + 4 * int((start | now.any(dim=0)).sum()) + 4 * n_new  # latencies
        + cells * 9 + slots * 25  # every output
    )


def fmp_rv_now(args, start):
    """``[A, G, W]``: where a classic Phase2a lands at ``t`` (the carried
    one where recovery does not start, the recovery's at a classic
    latency of 0 where it does)."""
    t = int(args[-1])
    return torch.where(start[None], (args[11] == 0)[None], args[6] == t)


def fmp_vote_route_bytes(args, **statics) -> int:
    """The bytes the kernel's scalar route moves on these inputs (as
    :func:`fmp_vote_needed_bytes`): every dense input field (the classic
    Phase2a and Phase2b ticks, vote bits, chosen values and replica
    arrivals where the function does not need them too), the latencies
    where the function needs them, every output."""
    A, G, W = args[0].shape
    cells, slots = A * G * W, G * W
    out = reference_fmp_vote(*args, **statics)
    start, newly = out[11], out[9]
    rv_lat = start | fmp_rv_now(args, start).any(dim=0)
    return (
        cells * 17 + slots * 21  # the dense fields in
        + 4 * int(rv_lat.sum()) + 4 * int(newly.sum())  # the latencies
        + cells * 9 + slots * 25  # every output
    )


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# The acceptor counts the scalar route is built for (csrc/fastmultipaxos.cu)
# and its default threads a CTA.
SCALAR_A = (3, 5, 7, 9)
SCALAR_THREADS = 128


def fmp_vote_route(*args) -> str:
    """The vote kernel's route for the plane's arguments (those of
    :func:`fused_fmp_vote`): "scalar" (a thread a slot, every dense load
    before any store) when A is in SCALAR_A; else "general" (the kernel as
    first written, A at run time). The kernel refuses the scalar route
    where A is not in SCALAR_A."""
    return "scalar" if args[0].shape[0] in SCALAR_A else "general"


def _threads(route: str, block: int) -> int:
    """Threads a CTA: the scalar route's ``block`` cut to whole warps up
    to 256 (its launch bounds; SCALAR_THREADS unless given), the general
    route's ``block`` (256 unless given)."""
    if route == "general":
        return block or 256
    return min(256, block // 32 * 32) if block else SCALAR_THREADS


# Pointer slots of the kernel's argument block, in the order of the `Slot`
# enum of csrc/fastmultipaxos.cu.
_PTR_SLOTS = (
    "vv", "vs", "status", "ot", "fc", "rvv", "rp2a", "rp2b", "rvoted",
    "cv", "ra", "rvlat", "replylat",
    "o_status", "o_ot", "o_fc", "o_rvv", "o_rp2a", "o_rp2b", "o_rvoted",
    "o_cv", "o_ra", "o_newly", "o_fast", "o_rec", "o_safety",
)
_IN_SPECS = {  # slot: (shape kind, dtype)
    "vv": ("agw", torch.int32), "vs": ("agw", torch.int32),
    "status": ("gw", torch.int8), "ot": ("gw", torch.int32),
    "fc": ("gw", torch.int32), "rvv": ("gw", torch.int32),
    "rp2a": ("agw", torch.int32), "rp2b": ("agw", torch.int32),
    "rvoted": ("agw", torch.bool), "cv": ("gw", torch.int32),
    "ra": ("gw", torch.int32), "rvlat": ("gw", torch.int32),
    "replylat": ("gw", torch.int32),
}


def _fmp_vote_kernel(
    vote_value, vote_seen, status, open_tick, fast_committed, rv_value,
    rv_p2a_arrival, rv_p2b_arrival, rv_voted, chosen_value, replica_arrival,
    rv_lat, reply_lat, t, block: int = 0, *, fq: int, f: int,
    recovery_timeout: int,
):
    """Check the tensors, pick the route (:func:`fmp_vote_route`),
    allocate the outputs and pack the launch; returns ``(launch,
    outputs)``. The launch loads the CUDA library, so the checks run
    without a card; it carries ``route`` and ``packed``, the library
    call's arguments (``harness/chain_race.py`` calls other builds of the
    source with them)."""
    from frankenpaxos_tpu_torch.ops import _build

    A, G, W = vote_value.shape
    ins = dict(
        vv=vote_value, vs=vote_seen, status=status, ot=open_tick,
        fc=fast_committed, rvv=rv_value, rp2a=rv_p2a_arrival,
        rp2b=rv_p2b_arrival, rvoted=rv_voted, cv=chosen_value,
        ra=replica_arrival, rvlat=rv_lat, replylat=reply_lat,
    )
    shapes = {"agw": (A, G, W), "gw": (G, W)}
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
    if block and not 32 <= block <= 1024:
        raise ValueError(f"{_PLANE}: block={block} threads, want 32-1024")
    route = fmp_vote_route(*ins.values())
    threads = _threads(route, block)

    dev = vote_value.device

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = dict(
        o_status=empty((G, W), torch.int8),
        o_ot=empty((G, W), torch.int32),
        o_fc=empty((G, W), torch.int32),
        o_rvv=empty((G, W), torch.int32),
        o_rp2a=empty((A, G, W), torch.int32),
        o_rp2b=empty((A, G, W), torch.int32),
        o_rvoted=empty((A, G, W), torch.bool),
        o_cv=empty((G, W), torch.int32),
        o_ra=empty((G, W), torch.int32),
        o_newly=empty((G, W), torch.bool),
        o_fast=empty((G, W), torch.bool),
        o_rec=empty((G, W), torch.bool),
        o_safety=empty((G, W), torch.bool),
    )
    tensors = {**ins, **outs}
    ptrs = (ctypes.c_void_p * len(_PTR_SLOTS))(
        *[tensors[s].data_ptr() for s in _PTR_SLOTS]
    )
    ints = (ctypes.c_int * 9)(
        A, G, W, t, fq, f, recovery_timeout, threads,
        registry.ROUTES.index(route),
    )

    def launch() -> None:
        lib = _build.kernel_lib("fpx_fmp", len(_PTR_SLOTS))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fpx_fmp_launch(ptrs, ints, stream)
        if err != 0:
            raise RuntimeError(
                f"{_PLANE}: kernel launch failed: "
                f"{lib.fpx_error_string(err).decode()} (cuda error {err})"
            )
        registry.count_launch(_PLANE, route)

    launch.route = route
    launch.packed = (ptrs, ints)
    order = ("o_status", "o_ot", "o_fc", "o_rvv", "o_rp2a", "o_rp2b",
             "o_rvoted", "o_cv", "o_ra", "o_newly", "o_fast", "o_rec",
             "o_safety")
    return launch, tuple(outs[k] for k in order)


def fused_fmp_vote(
    vote_value, vote_seen, status, open_tick, fast_committed, rv_value,
    rv_p2a_arrival, rv_p2b_arrival, rv_voted, chosen_value, replica_arrival,
    rv_lat, reply_lat, t, block: int = 0, *, fq: int = 2, f: int = 1,
    recovery_timeout: int = 10,
):
    """:func:`reference_fmp_vote` as one CUDA kernel on the card (the
    plain version on the CPU). Replaces the Pallas ``fused_fmp_vote``
    (frankenpaxos_tpu/ops/fastmultipaxos.py:266), on the route of
    :func:`fmp_vote_route`. Bound by bytes: 13.0 MB needed at (3, 3334,
    32). Bit-exact: integer work only, ``jnp.argmax``'s first maximum kept
    by strict-``>`` scans."""
    args = (
        vote_value, vote_seen, status, open_tick, fast_committed, rv_value,
        rv_p2a_arrival, rv_p2b_arrival, rv_voted, chosen_value,
        replica_arrival, rv_lat, reply_lat,
    )
    statics = dict(fq=fq, f=f, recovery_timeout=recovery_timeout)
    if on_cpu(args):
        return reference_fmp_vote(*args, t, **statics)
    launch, out = _fmp_vote_kernel(*args, t, block, **statics)
    launch()
    return out


def prepared_launch(*args, **statics) -> tuple:
    """For timing the kernel apart from its wrapper: checks the tensors
    ``args`` (the wrapper's arguments), picks the route, allocates the
    outputs and returns ``(launch, outputs)``; each ``launch()`` runs the
    kernel once into those outputs (and counts as a launch on its route,
    ``launch.route``). On CPU tensors it runs the wrapper's checks alone:
    only the launch needs the card."""
    return _fmp_vote_kernel(*args, **statics)


# ---------------------------------------------------------------------------
# Example inputs: numpy arrays in the State's dtype policy, from a seed.
# ---------------------------------------------------------------------------

EDGE_CASES = ("random", "no_visible", "all_distinct", "ties", "at_timeout",
              "contradicted", "zero_lat")


def example_fmp_vote_args(rng, A, G, W, t=40, case="random", recovery_timeout=10):
    """Inputs of the plane at ``(A, G, W)`` (``t`` last). ``case``:

    * ``"random"``: votes from a few values with NO_VALUE holes, seen now,
      earlier or later; open, recovering and chosen slots; classic rounds
      in flight, arriving now or voted;
    * ``"no_visible"``: every vote seen after ``t``;
    * ``"all_distinct"``: a full visible census of distinct values in
      open slots, so recovery starts from acceptor 0's value;
    * ``"ties"``: two values with equal counts (plus holes), visible;
    * ``"at_timeout"``: open slots opened exactly ``recovery_timeout``
      ticks ago with ``A - f`` visible votes, or one tick too recently;
    * ``"contradicted"``: a fast-committed value in the ledger and a
      fast quorum (or a recovery) for another value (the ``safety`` row);
    * ``"zero_lat"``: the random inputs with a classic latency of 0 on
      about half the slots, so a recovery that starts now votes now, and a
      classic Phase2a that arrives now lands its Phase2b now (a slot chosen
      through replies that land this tick).
    """
    shape, gw = (A, G, W), (G, W)
    f = (A - 1) // 2
    i32 = np.int32
    vv = rng.integers(0, 3, shape) + 100 * rng.integers(0, 2, (1, G, W))
    vv = np.where(rng.random(shape) < 0.15, NO_VALUE, vv)
    vs = t + rng.integers(-4, 3, shape)
    status = rng.choice([S_OPEN, S_OPEN, S_RECOVER, S_CHOSEN], gw)
    open_tick = np.where(rng.random(gw) < 0.5, t - rng.integers(0, 15, gw), INF)
    fc = np.where(rng.random(gw) < 0.2, rng.integers(0, 3, gw), NO_VALUE)
    rvv = np.where(status == S_RECOVER, rng.integers(0, 3, gw), NO_VALUE)
    rp2a = np.where(
        (status == S_RECOVER)[None] & (rng.random(shape) < 0.5),
        t + rng.integers(-1, 3, shape), INF,
    )
    rp2b = np.where(rng.random(shape) < 0.4, t + rng.integers(-2, 3, shape), INF)
    rvoted = rng.random(shape) < 0.3
    cv = np.where(status == S_CHOSEN, rng.integers(0, 3, gw), NO_VALUE)
    ra = np.where(status == S_CHOSEN, t + rng.integers(-2, 3, gw), INF)
    if case == "no_visible":
        vs = t + rng.integers(1, 5, shape)
    elif case == "all_distinct":
        vv = np.broadcast_to(np.arange(A)[:, None, None] + 7, shape)
        vs = np.full(shape, t - 1)
        status = np.full(gw, S_OPEN)
        open_tick = np.full(gw, t - 1)
        fc = np.full(gw, NO_VALUE)
    elif case == "ties":
        vv = np.where(np.arange(A)[:, None, None] % 2 == 0, 5, 9) + 0 * vv
        vv = np.where(np.arange(A)[:, None, None] == A - 1, NO_VALUE, vv)
        vs = np.full(shape, t)
        status = np.full(gw, S_OPEN)
    elif case == "at_timeout":
        seen = np.arange(A)[:, None, None] < A - f
        vs = np.where(seen, t - 2, t + 3) + 0 * vs
        vv = np.broadcast_to(np.arange(A)[:, None, None], shape)
        status = np.full(gw, S_OPEN)
        open_tick = t - recovery_timeout + rng.integers(0, 2, gw)
    elif case == "contradicted":
        vv = np.full(shape, 3)
        vs = np.full(shape, t - 1)
        status = rng.choice([S_OPEN, S_RECOVER], gw)
        fc = np.full(gw, 4)
        rvv = np.full(gw, 6)
        rp2b = np.where(rng.random(shape) < 0.8, t - 1, INF)
        rvoted = np.ones(shape, bool)
    elif case not in ("random", "zero_lat"):
        raise ValueError(f"unknown case {case!r}; known: {EDGE_CASES}")
    rv_lat = rng.integers(1, 4, gw)
    reply_lat = rng.integers(1, 4, gw)
    if case == "zero_lat":
        rv_lat = np.where(rng.random(gw) < 0.5, 0, rv_lat)
    return (
        np.ascontiguousarray(vv, dtype=i32),
        np.ascontiguousarray(vs, dtype=i32),
        np.asarray(status, np.int8),
        np.asarray(open_tick, i32),
        np.asarray(fc, i32),
        np.asarray(rvv, i32),
        rp2a.astype(i32),
        rp2b.astype(i32),
        rvoted,
        cv.astype(i32),
        ra.astype(i32),
        rv_lat.astype(i32),
        reply_lat.astype(i32),
        t,
    )


registry.register(
    registry.Plane(
        name=_PLANE,
        backend="fastmultipaxos",
        reference=reference_fmp_vote,
        kernel=fused_fmp_vote,
        source=_SOURCE,
        replaces="frankenpaxos_tpu/ops/fastmultipaxos.py:266 fused_fmp_vote "
        "(pallas_call :339)",
    )
)
