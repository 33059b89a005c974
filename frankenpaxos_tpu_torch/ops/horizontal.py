"""The Horizontal MultiPaxos vote plane: its plain PyTorch version and the
wrapper of its hand-written CUDA kernel (``csrc/horizontal.cu``).

One plane of ``tpu/horizontal_batched.py`` dispatches here:
``horizontal_vote`` (:func:`fused_horizontal_vote`, replaces the Pallas
``fused_horizontal_vote`` at ``frankenpaxos_tpu/ops/horizontal.py:154``).
It covers tick steps 1-2: the acceptors of the slot's BANK vote on the
Phase2a messages that arrive now (the pool is two banks of ``n = 2f+1``
rows; the parity of the slot's chunk epoch picks the bank), schedule
their Phase2b replies, the in-bank quorum count chooses, and the
bank-isolation ledger counts the votes that sit in the wrong bank.

The pool-axis planes are ``[P, G, W]`` with ``P = 2n`` (bank 0 = rows
``[0, n)``, bank 1 = rows ``[n, 2n)``). An empty slot's epoch is -1,
which the floor ``%`` maps to bank 1, as ``jnp.mod`` does.

:func:`reference_horizontal_vote` is the plain version, line for line the
JAX reference twin, with its outputs and dtypes. ``p2b_delivered=None``
means every Phase2b reply is delivered (the JAX tick passes an all-ones
plane when no fault plan is set); the kernel then reads no delivery
plane. The wrapper runs the plain version when its tensors lie on the
CPU and launches the kernel when they lie on the card; it never falls
back from the card to the plain version.

The kernel has two routes (:func:`horizontal_vote_route`): the vector
route, which every configuration of the repo takes (four slots a pair of
threads, one bank's rows each, 16-byte loads, every load of a row before
its stores), and the general kernel (a thread a slot) for the shapes it
does not take.

Bound: a few integer ops per byte, so bound by the bytes moved. The bytes
these inputs need (:func:`horizontal_vote_needed_bytes`: a cell's
latency, delivery bit, vote and vote epoch only where the function uses
them) are 15.35 MB at ``(P, G, W) = (6, 3334, 32)`` on the main path's
inputs (4.6 us at 3.35 TB/s); every input and output once is 18.46 MB.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from frankenpaxos_tpu_torch.ops import registry
from frankenpaxos_tpu_torch.ops.registry import on_cpu
from frankenpaxos_tpu_torch.tpu.common import INF, sum32

_SOURCE = "frankenpaxos_tpu_torch/csrc/horizontal.cu"
_PLANE = "horizontal_vote"

# Mirrors of the backend's slot codes (cross-checked by the tests).
EMPTY = 0
PROPOSED = 1
CHOSEN = 2
NO_VALUE = -1

HORIZONTAL_VOTE_OUTS = (
    "status", "p2a_arrival", "p2b_arrival", "voted", "vote_epoch",
    "newly_chosen", "lat", "viol",
)


# ---------------------------------------------------------------------------
# Plain version (the specification the kernel is held against)
# ---------------------------------------------------------------------------


def reference_horizontal_vote(
    slot_epoch,  # [G, W] int16 chunk epoch stamped at proposal (-1)
    status,  # [G, W] int8
    propose_tick,  # [G, W] int32
    p2a_arrival,  # [P, G, W] int32 absolute arrival ticks (INF)
    p2b_arrival,  # [P, G, W] int32
    voted,  # [P, G, W] bool
    vote_epoch,  # [P, G, W] int16 epoch the vote was cast under
    p2b_lat,  # [P, G, W] int32 sampled latencies
    p2b_delivered,  # [P, G, W] bool, or None (every reply delivered)
    t,  # current tick (int)
    *,
    n: int,
    quorum: int,
):
    """Tick steps 1-2 of horizontal_batched. Returns ``(status',
    p2a_arrival', p2b_arrival', voted', vote_epoch', newly_chosen [G, W]
    bool, lat [G, W] int32, viol [G, W] int32)``."""
    P = p2a_arrival.shape[0]
    dev = p2a_arrival.device
    bank_of_row = (torch.arange(P, dtype=torch.int32, device=dev) >= n).to(
        torch.int32
    )

    # 1. Acceptors vote on arriving Phase2as, only in the slot's bank.
    slot_bank = slot_epoch % 2  # floor mod: -1 -> bank 1
    row_matches = bank_of_row[:, None, None] == slot_bank[None, :, :]
    proposed = status == PROPOSED
    p2a_now = p2a_arrival == t
    may_vote = p2a_now & row_matches & proposed[None, :, :]
    new_voted = voted | may_vote
    new_vote_epoch = torch.where(may_vote, slot_epoch[None, :, :], vote_epoch)
    # The vote lands even where its Phase2b reply is dropped.
    p2b_send = may_vote if p2b_delivered is None else may_vote & p2b_delivered
    new_p2b = torch.where(p2b_send, t + p2b_lat, p2b_arrival)
    new_p2a = torch.where(p2a_now, INF, p2a_arrival)

    # 2. Quorums form: f+1 arrived Phase2bs within the slot's bank.
    arrived = (new_p2b <= t) & new_voted & row_matches
    votes_in_bank = sum32(arrived, dim=0)
    newly_chosen = proposed & (votes_in_bank >= quorum)
    new_status = torch.where(newly_chosen, CHOSEN, status)
    lat = torch.where(newly_chosen, t - propose_tick, 0)
    # Bank isolation ledger: votes outside their slot's bank.
    viol = sum32(
        new_voted & ~row_matches & (slot_epoch >= 0)[None, :, :], dim=0
    )
    return (
        new_status, new_p2a, new_p2b, new_voted, new_vote_epoch,
        newly_chosen, lat, viol,
    )


def horizontal_vote_needed_bytes(args, *, n: int, quorum: int) -> int:
    """The bytes :func:`reference_horizontal_vote` must move on these
    inputs (``args``: its positional arguments, ``t`` last): of every pool
    cell its Phase2a tick, and its vote, vote epoch and Phase2b tick where
    no vote lands; where one lands, its delivery bit (when there is a
    delivery plane), its latency where the reply is sent and its Phase2b
    tick where it is dropped; of every slot its epoch and status, its
    proposal tick only where it is newly chosen; and every output once."""
    se, status, _, p2a, _, _, _, _, deliv, t = args
    P, G, W = p2a.shape
    cells, slots = P * G * W, G * W
    bank = (torch.arange(P, device=p2a.device) >= n).to(torch.int32)
    may = (
        (p2a == int(t)) & (bank[:, None, None] == (se % 2)[None])
        & (status == PROPOSED)[None]
    )
    n_may = int(may.sum())
    n_send = n_may if deliv is None else int((may & deliv).sum())
    newly = reference_horizontal_vote(*args, n=n, quorum=quorum)[5]
    return (
        cells * 4  # Phase2a ticks in
        + (cells - n_may) * 7  # vote, vote epoch and Phase2b tick carried
        + (0 if deliv is None else n_may)  # delivery bits of the votes
        + n_send * 4 + (n_may - n_send) * 4  # latency, or Phase2b dropped
        + cells * 11  # Phase2a, Phase2b, vote and vote epoch out
        + slots * 3 + int(newly.sum()) * 4  # epoch, status; proposal tick
        + slots * 10  # status, newly chosen, latency and ledger out
    )


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# Consecutive slots a pair of threads of the vector route owns
# (csrc/horizontal.cu kLanes), and its default threads a CTA.
VEC_LANES = 4
VEC_THREADS = 128


def horizontal_vote_route(*args, block: int = 0) -> str:
    """The vote kernel's route for the plane's arguments (those of
    :func:`fused_horizontal_vote`): "vector" when W % VEC_LANES == 0, the
    block is a whole number of warps up to 256 threads and every tensor is
    16-byte aligned; else "general" (a thread a slot, any W). The kernel
    refuses the vector route where its conditions do not hold."""
    W = args[3].shape[2]
    if (
        W % VEC_LANES == 0
        and block <= 256
        and block % 32 == 0
        and registry.aligned16(args)
    ):
        return "vector"
    return "general"


# Pointer slots of the kernel's argument block, in the order of the `Slot`
# enum of csrc/horizontal.cu.
_PTR_SLOTS = (
    "se", "status", "pt", "p2a", "p2b", "voted", "ve", "lat", "deliv",
    "o_status", "o_p2a", "o_p2b", "o_voted", "o_ve", "o_newly", "o_lat",
    "o_viol",
)
_IN_SPECS = {  # slot: (shape kind, dtype)
    "se": ("gw", torch.int16), "status": ("gw", torch.int8),
    "pt": ("gw", torch.int32), "p2a": ("pgw", torch.int32),
    "p2b": ("pgw", torch.int32), "voted": ("pgw", torch.bool),
    "ve": ("pgw", torch.int16), "lat": ("pgw", torch.int32),
    "deliv": ("pgw", torch.bool),
}


def _horizontal_vote_kernel(
    slot_epoch, status, propose_tick, p2a_arrival, p2b_arrival, voted,
    vote_epoch, p2b_lat, p2b_delivered, t, block: int = 0, *, n: int,
    quorum: int,
):
    """Check the tensors, pick the route (:func:`horizontal_vote_route`),
    allocate the outputs and pack the launch; returns ``(launch,
    outputs)``. The launch loads the CUDA library, so the checks run
    without a card; it carries ``route`` and ``packed``, the library
    call's arguments (``harness/chain_race.py`` calls other builds of the
    source with them)."""
    from frankenpaxos_tpu_torch.ops import _build

    P, G, W = p2a_arrival.shape
    if n < 1 or P != 2 * n:
        raise ValueError(
            f"{_PLANE}: pool of {P} rows with n={n}; the plane takes P = 2n "
            f"(two banks of n rows)"
        )
    ins = dict(
        se=slot_epoch, status=status, pt=propose_tick, p2a=p2a_arrival,
        p2b=p2b_arrival, voted=voted, ve=vote_epoch, lat=p2b_lat,
        deliv=p2b_delivered,
    )
    shapes = {"pgw": (P, G, W), "gw": (G, W)}
    for slot, x in ins.items():
        if x is None and slot == "deliv":
            continue
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
    route = horizontal_vote_route(*ins.values(), block=block)
    threads = block or (VEC_THREADS if route == "vector" else 256)

    dev = p2a_arrival.device

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = dict(
        o_status=empty((G, W), torch.int8),
        o_p2a=empty((P, G, W), torch.int32),
        o_p2b=empty((P, G, W), torch.int32),
        o_voted=empty((P, G, W), torch.bool),
        o_ve=empty((P, G, W), torch.int16),
        o_newly=empty((G, W), torch.bool),
        o_lat=empty((G, W), torch.int32),
        o_viol=empty((G, W), torch.int32),
    )
    tensors = {**ins, **outs}
    ptrs = (ctypes.c_void_p * len(_PTR_SLOTS))(
        *[
            None if tensors[s] is None else tensors[s].data_ptr()
            for s in _PTR_SLOTS
        ]
    )
    ints = (ctypes.c_int * 7)(
        n, G, W, t, quorum, threads, registry.ROUTES.index(route)
    )

    def launch() -> None:
        lib = _build.kernel_lib("fpx_horizontal", len(_PTR_SLOTS))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fpx_horizontal_launch(ptrs, ints, stream)
        if err != 0:
            raise RuntimeError(
                f"{_PLANE}: kernel launch failed: "
                f"{lib.fpx_error_string(err).decode()} (cuda error {err})"
            )
        registry.count_launch(_PLANE, route)

    launch.route = route
    launch.packed = (ptrs, ints)
    order = ("o_status", "o_p2a", "o_p2b", "o_voted", "o_ve", "o_newly",
             "o_lat", "o_viol")
    return launch, tuple(outs[k] for k in order)


def fused_horizontal_vote(
    slot_epoch, status, propose_tick, p2a_arrival, p2b_arrival, voted,
    vote_epoch, p2b_lat, p2b_delivered, t, block: int = 0, *, n: int = 3,
    quorum: int = 2,
):
    """:func:`reference_horizontal_vote` as one CUDA kernel on the card
    (the plain version on the CPU). Replaces the Pallas
    ``fused_horizontal_vote`` (frankenpaxos_tpu/ops/horizontal.py:154),
    on the route of :func:`horizontal_vote_route`. Bound by bytes: 15.35
    MB needed at (6, 3334, 32). Bit-exact: integer work only, the epoch's
    bank by floor ``%``, the reply tick added in wrapping int32."""
    args = (
        slot_epoch, status, propose_tick, p2a_arrival, p2b_arrival, voted,
        vote_epoch, p2b_lat, p2b_delivered,
    )
    statics = dict(n=n, quorum=quorum)
    if on_cpu([a for a in args if a is not None]):
        return reference_horizontal_vote(*args, t, **statics)
    launch, out = _horizontal_vote_kernel(*args, t, block, **statics)
    launch()
    return out


def prepared_launch(*args, **statics) -> tuple:
    """For timing the kernel apart from its wrapper: checks the tensors
    ``args`` (the wrapper's arguments), picks the route, allocates the
    outputs and returns ``(launch, outputs)``; each ``launch()`` runs the
    kernel once into those outputs (and counts as a launch on its route,
    ``launch.route``). On CPU tensors it runs the wrapper's checks alone:
    only the launch needs the card."""
    return _horizontal_vote_kernel(*args, **statics)


# ---------------------------------------------------------------------------
# Example inputs: numpy arrays in the State's dtype policy, from a seed.
# ---------------------------------------------------------------------------

EDGE_CASES = ("random", "no_epoch", "all_now", "forged", "all_inf", "dropped")


def example_horizontal_vote_args(rng, P, G, W, t=40, case="random"):
    """Inputs of the plane at ``(P, G, W)`` (``t`` last; ``n = P // 2``).
    ``case``:

    * ``"random"``: empty, proposed and chosen slots with epochs -1..3;
      Phase2a arrivals now, earlier, later or never in both banks; Phase2b
      replies pending, landed or never; votes in both banks; some replies
      dropped;
    * ``"no_epoch"``: every slot epoch -1 (bank 1 by floor ``%``; the
      ledger skips them);
    * ``"all_now"``: every slot PROPOSED and every Phase2a arriving at
      ``t``;
    * ``"forged"``: votes in the wrong bank of stamped slots (``viol``);
    * ``"all_inf"``: no message in flight, no vote;
    * ``"dropped"``: every Phase2b reply dropped.
    """
    pgw, gw = (P, G, W), (G, W)
    n = P // 2
    i32 = np.int32
    slot_epoch = rng.integers(-1, 4, gw)
    status = rng.choice([0, 1, 1, 2], gw)
    propose_tick = np.where(status == 0, INF, t - rng.integers(0, 10, gw))
    kind = rng.integers(0, 4, pgw)  # 0 now, 1 earlier, 2 later, 3 never
    p2a = np.where(
        kind == 0, t,
        np.where(kind == 1, t - rng.integers(1, 5, pgw),
                 np.where(kind == 2, t + rng.integers(1, 5, pgw), INF)),
    )
    p2b = np.where(rng.random(pgw) < 0.5, t + rng.integers(-3, 4, pgw), INF)
    voted = rng.random(pgw) < 0.3
    vote_epoch = np.where(voted, rng.integers(0, 4, pgw), -1)
    deliv = rng.random(pgw) < 0.8
    bank_of_row = (np.arange(P) >= n)[:, None, None]
    if case == "no_epoch":
        slot_epoch = np.full(gw, -1)
    elif case == "all_now":
        status = np.full(gw, PROPOSED)
        propose_tick = t - rng.integers(0, 10, gw)
        p2a = np.full(pgw, t)
    elif case == "forged":
        slot_epoch = rng.integers(0, 4, gw)
        wrong = bank_of_row != (slot_epoch % 2)[None]
        voted = wrong & (rng.random(pgw) < 0.5)
    elif case == "all_inf":
        p2a = np.full(pgw, INF)
        p2b = np.full(pgw, INF)
        voted = np.zeros(pgw, bool)
    elif case == "dropped":
        deliv = np.zeros(pgw, bool)
    elif case != "random":
        raise ValueError(f"unknown case {case!r}; known: {EDGE_CASES}")
    return (
        np.asarray(slot_epoch, np.int16),
        np.asarray(status, np.int8),
        np.asarray(propose_tick, i32),
        np.ascontiguousarray(p2a, dtype=i32),
        np.ascontiguousarray(p2b, dtype=i32),
        np.ascontiguousarray(voted),
        np.ascontiguousarray(vote_epoch, dtype=np.int16),
        rng.integers(1, 4, pgw).astype(i32),  # p2b_lat
        np.ascontiguousarray(deliv),
        t,
    )


registry.register(
    registry.Plane(
        name=_PLANE,
        backend="horizontal",
        reference=reference_horizontal_vote,
        kernel=fused_horizontal_vote,
        source=_SOURCE,
        replaces="frankenpaxos_tpu/ops/horizontal.py:154 fused_horizontal_vote "
        "(pallas_call :212)",
    )
)
