"""The Compartmentalized MultiPaxos acceptor-grid plane: its plain
PyTorch version and the wrapper of its hand-written CUDA kernel
(``csrc/compartmentalized.cu``).

One plane of ``tpu/compartmentalized_batched.py`` dispatches here:
``compartmentalized_grid_vote`` (:func:`fused_grid_vote`, replaces the
Pallas ``fused_grid_vote`` at ``frankenpaxos_tpu/ops/compartmentalized.py:289``).
In one pass over the ``[R, C, G, W]`` grid and the ``[NR, G, W]``
replica plane it does:

* offset-clock aging of the Phase2a, Phase2b and commit-broadcast
  clocks (each exactly once);
* column-transversal write votes: an acceptor whose Phase2a arrives now
  sends its Phase2b to the slot's proxy leader (a min-write where the
  vote is delivered);
* every-row-voted chosen detection, gated on the slot's proxy being
  alive, and the commit broadcast to every replica;
* each replica's executed watermark over its contiguous arrived prefix;
* the retry: a timed-out PROPOSED slot re-sends Phase2a to the full
  grid (an overwrite of the aged clock, not a min-write).

:func:`reference_grid_vote` is the plain version, line for line the JAX
reference twin, with its outputs and dtypes. The wrapper runs it when
its tensors lie on the CPU and launches the kernel when they lie on the
card; it never falls back from the card to the plain version.

Bound: the kernel is bound by the bytes it moves (a few integer ops per
byte). At the main shape ``(R, C, NR, G, W) = (2, 2, 3, 25000, 32)`` the
function needs 57.7 MB on random inputs (:func:`grid_vote_needed_bytes`;
~94 MB if every input is read): ~17 us at 3.35 TB/s. The kernel has three
routes, chosen by :func:`grid_vote_route`: the vector route (8 slots a
thread, 16-byte loads), which the main path takes; the scalar route (a
thread a slot), which a grid past 2 x 2 cells (f = 2 runs 3 x 3) takes;
the general kernel (a CTA a group) past W = 1024.

:func:`unfused_grid_vote` (replaces the Pallas ``unfused_grid_vote`` at
``frankenpaxos_tpu/ops/compartmentalized.py:497``) is the same work in
six passes, each its own CUDA kernel that reads its inputs from device
memory and writes its outputs there: clock aging, the Phase2b vote, the
vote counts, the choose, the replica watermark and the retry. It exists
to be raced against the fused kernel (``harness/microbench.py``
``bench_grid_vote``): the six passes price the round trips of the
``[R, C, G, W]`` planes that the fused kernel deletes. Nothing in the
simulator dispatches it. :func:`reference_unfused_grid_vote` chains the
six plain passes, line for line the Pallas pass bodies.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from frankenpaxos_tpu_torch.ops import registry
from frankenpaxos_tpu_torch.ops.registry import on_cpu
from frankenpaxos_tpu_torch.tpu.common import INF, INF16, age_clock

# Mirrors of the backend's batch-slot codes (ops must not import the
# backend: the backend imports ops).
EMPTY = 0
PROPOSED = 1
CHOSEN = 2

_SOURCE = "frankenpaxos_tpu_torch/csrc/compartmentalized.cu"

GRID_VOTE_OUTS = (
    "p2a", "p2b", "rep_arrival", "status", "last_send", "rep_exec",
    "newly_chosen", "timed_out", "votes_cast", "votes_dropped",
)


# ---------------------------------------------------------------------------
# Plain version (the specification the kernel is held against)
# ---------------------------------------------------------------------------


def reference_grid_vote(
    p2a,  # [R, C, G, W] int16 Phase2a offset clocks (aged in-plane)
    p2b,  # [R, C, G, W] int16 Phase2b offset clocks (aged in-plane)
    rep_arrival,  # [NR, G, W] int16 commit-broadcast clocks (aged in-plane)
    status,  # [G, W] int8 EMPTY | PROPOSED | CHOSEN
    last_send,  # [G, W] int32 absolute ticks
    rep_exec,  # [NR, G] int32 per-replica executed watermarks
    head,  # [G] int32 ring heads
    next_slot,  # [G] int32 allocation frontiers
    alive_of_pos,  # [G, W] bool: the slot's proxy leader is alive
    p2b_del,  # [R, C, G, W] bool Phase2b delivery mask
    retry_del,  # [R, C, G, W] bool retry delivery mask
    p2b_lat,  # [R, C, G, W] int32 sampled latencies
    retry_lat,  # [R, C, G, W] int32
    rep_lat,  # [NR, G, W] int32
    t,  # current tick (int)
    *,
    retry_timeout: int,
):
    """Aging, votes, quorum/chosen, replica watermarks and the retry, as
    the JAX reference twin composes them. Returns ``(p2a, p2b,
    rep_arrival, status, last_send, rep_exec, newly_chosen, timed_out,
    votes_cast, votes_dropped)``; the vote counts are int32 ``[G, W]``."""
    W = status.shape[1]
    w_iota = torch.arange(W, dtype=torch.int32, device=status.device)
    p2a = age_clock(p2a)
    p2b = age_clock(p2b)
    rep_arrival = age_clock(rep_arrival)

    # Acceptors vote on Phase2a arrivals (idempotent min-write).
    voted_now = p2a == 0
    p2b = torch.where(
        voted_now & p2b_del, torch.minimum(p2b, p2b_lat.to(p2b.dtype)), p2b
    )

    # Chosen when every row has a vote in, collected by a live proxy.
    votes_in = p2b <= 0
    quorum = torch.all(torch.any(votes_in, dim=1), dim=0)  # [G, W]
    newly_chosen = (status == PROPOSED) & quorum & alive_of_pos
    status = torch.where(newly_chosen, CHOSEN, status)
    rep_arrival = torch.where(
        newly_chosen[None], rep_lat.to(rep_arrival.dtype), rep_arrival
    )

    # Per-replica watermark: the contiguous arrived prefix. As in JAX,
    # the live range tests the ring POSITION against next - head.
    ord_of_pos = (w_iota[None, :] - head[:, None]) % W  # [G, W]
    live_ord = w_iota[None, :] < (next_slot - head)[:, None]
    exec_ready = (status == CHOSEN)[None] & (rep_arrival <= 0)
    ord_ready = exec_ready & live_ord[None]
    first_gap = torch.amin(
        torch.where(ord_ready, W, ord_of_pos[None]), dim=2
    )  # [NR, G]
    rep_exec = torch.maximum(rep_exec, head[None, :] + first_gap)

    # Retries overwrite the aged clock with a fresh arrival.
    timed_out = (
        (status == PROPOSED) & (t - last_send >= retry_timeout) & alive_of_pos
    )
    resend = timed_out[None, None] & retry_del
    p2a = torch.where(resend, retry_lat.to(p2a.dtype), p2a)
    last_send = torch.where(timed_out, t, last_send)

    votes_cast = voted_now.sum(dim=(0, 1), dtype=torch.int32)
    votes_dropped = (voted_now & ~p2b_del).sum(dim=(0, 1), dtype=torch.int32)
    return (
        p2a, p2b, rep_arrival, status, last_send, rep_exec,
        newly_chosen, timed_out, votes_cast, votes_dropped,
    )


def grid_vote_needed_bytes(args, outs) -> int:
    """The bytes :func:`reference_grid_vote` must move on these inputs
    (``args``: its positional arguments; ``outs``: its outputs on them):
    every input and output once, except p2b_del at cells that do not
    vote, p2b_lat where no vote is delivered, retry_del at the cells of
    slots that do not time out, retry_lat where no re-send lands and
    rep_lat at slots not newly chosen: the kernels read those only where
    they are used."""
    p2a = args[0]
    R, C, G, W = p2a.shape
    NR = args[2].shape[0]
    cells, rep_cells = R * C * G * W, NR * G * W
    voted = int(outs[8].sum())
    delivered = voted - int(outs[9].sum())
    timed = outs[7]
    resent = int((timed[None, None] & args[10]).sum())
    armed = int(outs[6].sum()) * NR
    moved = sum(x.numel() * x.element_size()
                for x in (*args, *outs) if isinstance(x, torch.Tensor))
    skip = ((cells - voted) + (cells - delivered) * 4
            + (cells - int(timed.sum()) * R * C) + (cells - resent) * 4
            + (rep_cells - armed) * 4)
    return moved - skip


# ---------------------------------------------------------------------------
# The six-pass twin: plain passes (line for line the Pallas pass bodies of
# frankenpaxos_tpu/ops/compartmentalized.py:382-495)
# ---------------------------------------------------------------------------

UNFUSED_PASSES = ("age", "vote", "counts", "choose", "replica", "retry")


def _uf_age(p2a, p2b, rep_arrival):
    """Pass 1: clock aging of the three clock planes."""
    return age_clock(p2a), age_clock(p2b), age_clock(rep_arrival)


def _uf_vote(p2a, p2b, p2b_del, p2b_lat):
    """Pass 2: acceptors whose aged Phase2a arrives now vote (the
    Phase2b min-write where the vote is delivered)."""
    voted = p2a == 0
    return torch.where(
        voted & p2b_del, torch.minimum(p2b, p2b_lat.to(p2b.dtype)), p2b
    )


def _uf_counts(p2a, p2b_del):
    """Pass 3: the vote mask read again for the tick's proxy-load and
    telemetry counts: votes cast and dropped, int32 ``[G, W]``."""
    voted = p2a == 0
    votes = voted.sum(dim=(0, 1), dtype=torch.int32)
    dropped = (voted & ~p2b_del).sum(dim=(0, 1), dtype=torch.int32)
    return votes, dropped


def _uf_choose(p2b, status, alive_of_pos):
    """Pass 4: every row voted, collected by a live proxy: CHOSEN, and
    the newly-chosen mask."""
    quorum = torch.all(torch.any(p2b <= 0, dim=1), dim=0)
    newly = (status == PROPOSED) & quorum & alive_of_pos
    return torch.where(newly, CHOSEN, status), newly


def _uf_replica(rep_arrival, status, newly, rep_exec, head, next_slot, rep_lat):
    """Pass 5: the commit broadcast is armed at newly-chosen slots, and
    each replica's watermark advances over its contiguous arrived prefix
    (the live range tests the ring position, as in JAX)."""
    W = status.shape[1]
    w_iota = torch.arange(W, dtype=torch.int32, device=status.device)
    ord_of_pos = (w_iota[None, :] - head[:, None]) % W
    live_ord = w_iota[None, :] < (next_slot - head)[:, None]
    rep = torch.where(newly[None], rep_lat.to(rep_arrival.dtype), rep_arrival)
    ready = (status == CHOSEN)[None] & (rep <= 0) & live_ord[None]
    first_gap = torch.amin(torch.where(ready, W, ord_of_pos[None]), dim=2)
    return rep, torch.maximum(rep_exec, head[None, :] + first_gap)


def _uf_retry(p2a, status, last_send, alive_of_pos, retry_del, retry_lat, t,
              *, retry_timeout: int):
    """Pass 6: a timed-out PROPOSED slot re-sends Phase2a to the full
    grid, overwriting the aged clock (``p2a`` is the aged plane of pass
    1, ``status`` the chosen one of pass 4)."""
    timed = (status == PROPOSED) & (t - last_send >= retry_timeout) & alive_of_pos
    resend = timed[None, None] & retry_del
    p2a = torch.where(resend, retry_lat.to(p2a.dtype), p2a)
    return p2a, torch.where(timed, t, last_send), timed


# The planes each pass reads and writes, by the wrapper's pointer-slot
# names ("a_*": the aged clock planes that pass 1 writes), in the order of
# the plain pass's arguments and outputs (``t`` aside): what a pass moves
# through device memory.
UNFUSED_PASS_IO = {
    "age": (("p2a", "p2b", "rep"), ("a_p2a", "a_p2b", "a_rep")),
    "vote": (("a_p2a", "a_p2b", "p2b_del", "p2b_lat"), ("o_p2b",)),
    "counts": (("a_p2a", "p2b_del"), ("o_votes", "o_dropped")),
    "choose": (("o_p2b", "status", "alive"), ("o_status", "o_newly")),
    "replica": (
        ("a_rep", "o_status", "o_newly", "rep_exec", "head", "next", "rep_lat"),
        ("o_rep", "o_rep_exec"),
    ),
    "retry": (
        ("a_p2a", "o_status", "ls", "alive", "retry_del", "retry_lat"),
        ("o_p2a", "o_ls", "o_timed"),
    ),
}


def reference_unfused_passes(
    p2a, p2b, rep_arrival, status, last_send, rep_exec, head, next_slot,
    alive_of_pos, p2b_del, retry_del, p2b_lat, retry_lat, rep_lat, t,
    *,
    retry_timeout: int,
) -> dict:
    """The six plain passes chained as the Pallas ``unfused_grid_vote``
    chains its kernels: ``{pass: outputs}``, each pass's outputs in the
    order of :data:`UNFUSED_PASS_IO`."""
    age = _uf_age(p2a, p2b, rep_arrival)
    vote = (_uf_vote(age[0], age[1], p2b_del, p2b_lat),)
    counts = _uf_counts(age[0], p2b_del)
    choose = _uf_choose(vote[0], status, alive_of_pos)
    replica = _uf_replica(
        age[2], choose[0], choose[1], rep_exec, head, next_slot, rep_lat
    )
    retry = _uf_retry(
        age[0], choose[0], last_send, alive_of_pos, retry_del, retry_lat, t,
        retry_timeout=retry_timeout,
    )
    return dict(
        age=age, vote=vote, counts=counts, choose=choose, replica=replica,
        retry=retry,
    )


def _unfused_outputs(passes: dict) -> tuple:
    """The ten outputs of the grid vote, out of the passes' outputs."""
    (_, vote, counts, choose, replica, retry) = (
        passes[name] for name in UNFUSED_PASSES
    )
    return (
        retry[0], vote[0], replica[0], choose[0], retry[1], replica[1],
        choose[1], retry[2], counts[0], counts[1],
    )


def reference_unfused_grid_vote(*args, retry_timeout: int):
    """The six plain passes chained (:func:`reference_unfused_passes`);
    the outputs of :func:`reference_grid_vote`."""
    return _unfused_outputs(
        reference_unfused_passes(*args, retry_timeout=retry_timeout)
    )


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# Pointer slots of the kernel's argument block, in the order of the `Slot`
# enum of csrc/compartmentalized.cu.
_PTR_SLOTS = (
    "p2a", "p2b", "rep", "status", "ls", "rep_exec", "head", "next",
    "alive", "p2b_del", "retry_del", "p2b_lat", "retry_lat", "rep_lat",
    "o_p2a", "o_p2b", "o_rep", "o_status", "o_ls", "o_rep_exec",
    "o_newly", "o_timed", "o_votes", "o_dropped",
)
# The wrappers' tensor arguments by slot name, in argument order.
GRID_VOTE_IN_SLOTS = _PTR_SLOTS[:14]
_IN_SPECS = {  # slot: (shape kind, dtype)
    "p2a": ("rcgw", torch.int16), "p2b": ("rcgw", torch.int16),
    "rep": ("ngw", torch.int16), "status": ("gw", torch.int8),
    "ls": ("gw", torch.int32), "rep_exec": ("ng", torch.int32),
    "head": ("g", torch.int32), "next": ("g", torch.int32),
    "alive": ("gw", torch.bool), "p2b_del": ("rcgw", torch.bool),
    "retry_del": ("rcgw", torch.bool), "p2b_lat": ("rcgw", torch.int32),
    "retry_lat": ("rcgw", torch.int32), "rep_lat": ("ngw", torch.int32),
}
_PLANE = "compartmentalized_grid_vote"


def _check_inputs(
    plane: str, ins: dict, R: int, C: int, NR: int, G: int, W: int
) -> None:
    shapes = {
        "rcgw": (R, C, G, W), "ngw": (NR, G, W), "ng": (NR, G),
        "gw": (G, W), "g": (G,),
    }
    for slot, x in ins.items():
        kind, dtype = _IN_SPECS[slot]
        if tuple(x.shape) != shapes[kind]:
            raise ValueError(
                f"{plane}: {slot} has shape {tuple(x.shape)}, want "
                f"{shapes[kind]}"
            )
        if x.dtype != dtype:
            raise TypeError(
                f"{plane}: {slot} has dtype {x.dtype}, want {dtype} (the "
                f"kernel takes the State's dtype policy only)"
            )
        if not x.is_contiguous():
            raise ValueError(f"{plane}: {slot} is not contiguous")


def _prepare_grid_vote(
    plane, p2a, p2b, rep_arrival, status, last_send, rep_exec, head,
    next_slot, alive_of_pos, p2b_del, retry_del, p2b_lat, retry_lat, rep_lat,
    t, *, block=0, retry_timeout, fused,
):
    """The checks, launch shape and output allocation that the fused and
    the unfused wrappers share. Returns ``(ins, outs, ints, route)``: the
    input and output tensors by pointer slot, the launch's integer
    arguments ``(R, C, NR, G, W, t, retry_timeout, gpb, route code)`` and
    the route. ``fused``: the fused kernel takes :func:`grid_vote_route`;
    the six passes' replica pass runs a thread a slot, as the scalar
    route does. ``block``: groups per CTA (0: the route's default)."""
    R, C, G, W = p2a.shape
    NR = rep_arrival.shape[0]
    ins = dict(
        p2a=p2a, p2b=p2b, rep=rep_arrival, status=status, ls=last_send,
        rep_exec=rep_exec, head=head, next=next_slot, alive=alive_of_pos,
        p2b_del=p2b_del, retry_del=retry_del, p2b_lat=p2b_lat,
        retry_lat=retry_lat, rep_lat=rep_lat,
    )
    _check_inputs(plane, ins, R, C, NR, G, W)
    t = int(t)
    if not -(2**31) <= t < 2**31:
        raise ValueError(f"{plane}: tick {t} outside int32")
    route = grid_vote_route(*ins.values(), block=block) if fused else "scalar"
    gpb = _groups_per_cta(route, W, block)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=p2a.device)

    outs = dict(
        o_p2a=empty((R, C, G, W), p2a.dtype),
        o_p2b=empty((R, C, G, W), p2b.dtype),
        o_rep=empty((NR, G, W), rep_arrival.dtype),
        o_status=empty((G, W), status.dtype),
        o_ls=empty((G, W), last_send.dtype),
        o_rep_exec=empty((NR, G), rep_exec.dtype),
        o_newly=empty((G, W), torch.bool),
        o_timed=empty((G, W), torch.bool),
        o_votes=empty((G, W), torch.int32),
        o_dropped=empty((G, W), torch.int32),
    )
    ints = (R, C, NR, G, W, t, retry_timeout, gpb, registry.ROUTES.index(route))
    return ins, outs, ints, route


_OUT_ORDER = (
    "o_p2a", "o_p2b", "o_rep", "o_status", "o_ls", "o_rep_exec", "o_newly",
    "o_timed", "o_votes", "o_dropped",
)


def _groups_per_cta(route: str, W: int, block: int) -> int:
    """Groups a CTA holds on a route: ``block`` if given, else 256
    threads' worth (W threads a group on the scalar route, W / 8 on the
    vector route, at most 256 threads a CTA there); 1 on the general
    route (a CTA per group)."""
    if route == "general":
        return 1
    if route == "vector":
        per_group = W // 8
        return max(1, min(block or 256 // per_group, 256 // per_group))
    return max(1, min(block or 256 // W, 1024 // W))


# Grid cells, and replicas, whose rows a thread of the vector route holds
# in registers: kMaxRows of csrc/compartmentalized.cu, whose launcher
# refuses the vector route past it (chip_smoke.py's route cases at four
# and at six cells would then fail).
VECTOR_MAX_ROWS = 4


def grid_vote_route(*args, block: int = 0) -> str:
    """The grid-vote kernel's route for the plane's tensors (the
    arguments of :func:`fused_grid_vote`); the one place that decides it:

    * "vector" (8 slots a thread, 16-byte loads, every row of the slots
      in registers) when W % 8 == 0, W <= 1024, R * C and NR are at most
      VECTOR_MAX_ROWS and every tensor is 16-byte aligned;
    * else "scalar" (a thread a slot) for W <= 1024, when the CTA's
      per-replica gap table fits in 48 KB of shared memory;
    * else "general" (a CTA per group, any W).

    The kernel's launcher checks the route again and refuses it if its
    conditions do not hold."""
    R, C, _, _ = args[0].shape
    NR, _, W = args[2].shape
    if (W % 8 == 0 and W <= 1024 and max(R * C, NR) <= VECTOR_MAX_ROWS
            and registry.aligned16(args)):
        return "vector"
    if W <= 1024 and 4 * NR * _groups_per_cta("scalar", W, block) <= 48 * 1024:
        return "scalar"
    return "general"


def _launch_error(plane: str, lib, err: int, what: str = "kernel") -> None:
    if err != 0:
        raise RuntimeError(
            f"{plane}: {what} launch failed: "
            f"{lib.fpx_error_string(err).decode()} (cuda error {err})"
        )


def _grid_vote_kernel(*args, block: int = 0, retry_timeout: int):
    """Check the tensors, allocate the outputs and pack the launch;
    returns ``(launch, outputs)``. The launch loads the CUDA library, so
    the checks run without a card. ``args``: the wrapper's tensors and
    ``t``."""
    from frankenpaxos_tpu_torch.ops import _build

    ins, outs, ints, route = _prepare_grid_vote(
        _PLANE, *args, block=block, retry_timeout=retry_timeout, fused=True
    )
    tensors = {**ins, **outs}
    ptrs = (ctypes.c_void_p * len(_PTR_SLOTS))(
        *[tensors[s].data_ptr() for s in _PTR_SLOTS]
    )
    ints = (ctypes.c_int * len(ints))(*ints)
    device = ins["p2a"].device

    def launch() -> None:
        lib = _build.kernel_lib("fpx_cz", len(_PTR_SLOTS))
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch_error(_PLANE, lib, lib.fpx_cz_launch(ptrs, ints, stream))
        registry.count_launch(_PLANE, route)

    launch.route = route
    launch.packed = (ptrs, ints)
    return launch, tuple(outs[k] for k in _OUT_ORDER)


def fused_grid_vote(
    p2a, p2b, rep_arrival, status, last_send, rep_exec, head, next_slot,
    alive_of_pos, p2b_del, retry_del, p2b_lat, retry_lat, rep_lat, t,
    block: int = 0,
    *,
    retry_timeout: int = 8,
):
    """:func:`reference_grid_vote` as one CUDA kernel on the card (the
    plain version on the CPU). Replaces the Pallas ``fused_grid_vote``
    (frankenpaxos_tpu/ops/compartmentalized.py:289). Bound by bytes:
    57.7 MB needed at the main shape (2, 2, 3, 25000, 32) on random
    inputs, ~17 us at 3.35 TB/s (module docstring). Bit-exact: integer
    work only, ring ordinals floored, int16 clocks aged with the int16
    wrap."""
    args = (
        p2a, p2b, rep_arrival, status, last_send, rep_exec, head, next_slot,
        alive_of_pos, p2b_del, retry_del, p2b_lat, retry_lat, rep_lat,
    )
    if on_cpu(args):
        return reference_grid_vote(*args, t, retry_timeout=retry_timeout)
    launch, out = _grid_vote_kernel(
        *args, t, block=block, retry_timeout=retry_timeout
    )
    launch()
    return out


def prepared_launch(*args, **statics) -> tuple:
    """For timing the kernel apart from its wrapper: checks the tensors
    ``args`` (the wrapper's tensors and ``t``; ``statics``: ``block`` and
    ``retry_timeout`` by name), allocates the outputs and returns
    ``(launch, outputs)``; each ``launch()`` runs the kernel once into
    those outputs (and counts as a launch). On CPU tensors it runs the
    wrapper's checks alone: only the launch needs the card."""
    return _grid_vote_kernel(*args, **statics)


# ---------------------------------------------------------------------------
# The six-pass wrapper
# ---------------------------------------------------------------------------

# Pointer slots of the six passes' argument block, in the order of the
# `UfSlot` enum of csrc/compartmentalized.cu: the inputs, the three aged
# clock planes that pass 1 writes and later passes read, the outputs.
_UF_PTR_SLOTS = (
    GRID_VOTE_IN_SLOTS + ("a_p2a", "a_p2b", "a_rep") + _PTR_SLOTS[14:]
)
UNFUSED_PLANE = "compartmentalized_unfused_grid_vote"
UNFUSED_REPLACES = (
    "frankenpaxos_tpu/ops/compartmentalized.py:497 unfused_grid_vote "
    "(pallas_call :528, :545, :558, :574, :589, :605)"
)
# No plane dispatches the six-pass kernel (it is a race baseline of the
# microbench), so its launch count is set up here.
registry.LAUNCHES.setdefault(UNFUSED_PLANE, 0)


def prepared_unfused_launch(*args, block: int = 0, retry_timeout: int) -> tuple:
    """:func:`prepared_launch` for :func:`unfused_grid_vote`: returns
    ``(launch, outputs, passes)``. Each ``launch()`` runs the six passes
    once, in order on the current stream, into the same tensors, checks
    each launch, and counts one launch of the six-pass kernel.
    ``passes`` holds each pass's output tensors by pass name (the aged
    planes and the outputs, the layout of
    :func:`reference_unfused_passes`)."""
    from frankenpaxos_tpu_torch.ops import _build

    ins, outs, ints, _ = _prepare_grid_vote(
        UNFUSED_PLANE, *args, block=block, retry_timeout=retry_timeout,
        fused=False,
    )
    aged = {f"a_{k}": torch.empty_like(ins[k]) for k in ("p2a", "p2b", "rep")}
    tensors = {**ins, **aged, **outs}
    ptrs = (ctypes.c_void_p * len(_UF_PTR_SLOTS))(
        *[tensors[s].data_ptr() for s in _UF_PTR_SLOTS]
    )
    ints = (ctypes.c_int * len(ints))(*ints)
    device = ins["p2a"].device

    def launch() -> None:
        lib = _build.kernel_lib("fpx_czu", len(_UF_PTR_SLOTS))
        stream = torch.cuda.current_stream(device).cuda_stream
        for which, name in enumerate(UNFUSED_PASSES):
            err = lib.fpx_czu_launch(which, ptrs, ints, stream)
            _launch_error(UNFUSED_PLANE, lib, err, f"{name} pass")
        registry.count_launch(UNFUSED_PLANE)

    passes = {
        name: tuple(tensors[k] for k in written)
        for name, (_, written) in UNFUSED_PASS_IO.items()
    }
    return launch, tuple(outs[k] for k in _OUT_ORDER), passes


def unfused_grid_vote(
    p2a, p2b, rep_arrival, status, last_send, rep_exec, head, next_slot,
    alive_of_pos, p2b_del, retry_del, p2b_lat, retry_lat, rep_lat, t,
    block: int = 0,
    *,
    retry_timeout: int = 8,
):
    """:func:`reference_unfused_grid_vote` as six CUDA kernels on the
    card (the plain passes on the CPU); the signature and outputs of
    :func:`fused_grid_vote`. Replaces the Pallas ``unfused_grid_vote``
    (frankenpaxos_tpu/ops/compartmentalized.py:497). Bound by bytes:
    every pass reads its inputs from device memory and writes its outputs
    there, at most ~155 MB at the main shape (2, 2, 3, 25000, 32); the
    passes skip the masks and latencies they do not use (see
    csrc/compartmentalized.cu). ``block``: groups per CTA of the replica
    pass."""
    args = (
        p2a, p2b, rep_arrival, status, last_send, rep_exec, head, next_slot,
        alive_of_pos, p2b_del, retry_del, p2b_lat, retry_lat, rep_lat,
    )
    if on_cpu(args):
        return reference_unfused_grid_vote(*args, t, retry_timeout=retry_timeout)
    launch, out, _ = prepared_unfused_launch(
        *args, t, block=block, retry_timeout=retry_timeout
    )
    launch()
    return out


# ---------------------------------------------------------------------------
# Example inputs: numpy arrays in the State's dtype policy, from a seed.
# ---------------------------------------------------------------------------


def _np_clock(rng, shape, p=0.5, lo=-1, hi=4):
    """Offset clock: INF16 (never) or an offset in [lo, hi)."""
    return np.where(
        rng.random(shape) < p, rng.integers(lo, hi, shape), INF16
    ).astype(np.int16)


def example_grid_vote_args(rng, R, C, NR, G, W, t=33):
    """Inputs of the plane at ``(R, C, NR, G, W)``: random clocks drawn
    one tick early (the plane ages them), PROPOSED slots past their
    retry timeout, some dead proxies and dropped or undelivered
    messages, heads past W so the ring ordinals wrap. Returns the
    wrapper's positional arguments (``t`` last)."""
    status = rng.integers(0, 3, (G, W)).astype(np.int8)
    live = status > 0
    last_send = np.where(live, rng.integers(0, t + 1, (G, W)), INF)
    head = rng.integers(0, 100, (G,))
    next_slot = head + rng.integers(0, W + 1, (G,))
    rep_exec = head[None, :] + rng.integers(0, 3, (NR, G))
    i32 = np.int32
    return (
        _np_clock(rng, (R, C, G, W), lo=0, hi=3),  # p2a: 1 -> votes now
        _np_clock(rng, (R, C, G, W)),  # p2b
        _np_clock(rng, (NR, G, W), p=0.8, hi=2),  # rep_arrival: most land
        status,
        last_send.astype(i32),
        rep_exec.astype(i32),
        head.astype(i32),
        next_slot.astype(i32),
        rng.random((G, W)) < 0.9,  # alive_of_pos
        rng.random((R, C, G, W)) < 0.9,  # p2b_del
        rng.random((R, C, G, W)) < 0.9,  # retry_del
        rng.integers(1, 4, (R, C, G, W)).astype(i32),  # p2b_lat
        rng.integers(1, 4, (R, C, G, W)).astype(i32),  # retry_lat
        rng.integers(1, 4, (NR, G, W)).astype(i32),  # rep_lat
        t,
    )


registry.register(
    registry.Plane(
        name=_PLANE,
        backend="compartmentalized",
        reference=reference_grid_vote,
        kernel=fused_grid_vote,
        source=_SOURCE,
        replaces="frankenpaxos_tpu/ops/compartmentalized.py:289 "
        "fused_grid_vote (pallas_call :345)",
    )
)
