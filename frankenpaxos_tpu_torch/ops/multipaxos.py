"""The batched MultiPaxos tick planes: plain PyTorch versions and the
wrappers of their hand-written CUDA kernels (``csrc/multipaxos.cu``).

Four planes of ``tpu/multipaxos_batched.py`` dispatch here, each the
counterpart of a Pallas kernel of ``frankenpaxos_tpu/ops/multipaxos.py``:

* ``multipaxos_fused_tick`` (:func:`fused_tick`, replaces ``fused_tick``
  at ``ops/multipaxos.py:1029``): the whole-tick kernel. Offset-clock
  aging, the vote/quorum half and the dispatch half in one pass; the
  vote half's per-acceptor outputs stay in registers for the dispatch
  half. The tick's default route.
* ``multipaxos_vote_quorum`` (:func:`fused_vote_quorum`, replaces
  ``fused_vote_quorum`` at ``:216``): acceptors vote on Phase2a arrivals,
  schedule Phase2b arrivals, count per-slot quorums and Phase2b sends,
  and report each acceptor's max voted ordinal.
* ``multipaxos_dispatch`` (:func:`fused_mp_dispatch`, replaces
  ``fused_mp_dispatch`` at ``:738``): quorum -> Chosen, the
  contiguous-prefix commit watermark with its retire-clears, fresh
  proposals with their Phase2a fan-out, and timeout resends.
* ``multipaxos_p1_promise`` (:func:`fused_p1_promise`, replaces
  ``fused_p1_promise`` at ``:385``): phase-1 log repair for the groups
  that elect a leader, finish a reconfiguration, or change leader or
  configuration from the host: per in-flight slot the safe value, then
  the full-group re-send.

``disable=("multipaxos_fused_tick",)`` runs the vote and dispatch
planes back to back.

The ``reference_*`` functions are the plain versions, with the JAX
reference twins' signatures, outputs and dtypes. Each wrapper runs the
plain version when its tensors lie on the CPU, and launches its kernel
when they lie on the card; it never falls back from the card to the
plain version. The kernels take the State's dtype policy (int16 clocks
and rounds, int8 statuses, int32 ticks, ids and values) and every shape
the JAX kernels run: templated kernels for A = 2f+1 in {3, 5, 7, 9} and
W <= 1024, a general instantiation (runtime A, a loop over W) for the
rest. The phase-1 kernel has two routes instead (:func:`p1_promise_route`):
the vector route, which the failover path takes, and a thread a slot for
any A and W. A wrapper checks its tensors before it loads the CUDA
library, so ``prepared_launch`` on CPU tensors runs every check without
a card.

Bound: every kernel is bound by the bytes it moves (a few integer ops
per byte). At the flagship shape (A=3, G=3334, W=256) the fused tick
moves about 157 B per ring slot, ~134 MB a tick: ~40 us at 3.35 TB/s.
Bit exactness: C++ ``%`` truncates, so the kernels floor the ring
ordinals explicitly; int32 arithmetic that may wrap runs in uint32 (see
the note at the top of the CUDA source).
"""

from __future__ import annotations

import ctypes
from typing import Callable

import numpy as np
import torch

from frankenpaxos_tpu_torch.ops import registry
from frankenpaxos_tpu_torch.ops.registry import on_cpu
from frankenpaxos_tpu_torch.ops.registry import to_torch  # noqa: F401
from frankenpaxos_tpu_torch.tpu.common import (
    INF,
    INF16,
    age_clock,
    ring_retire_pos,
)

# Mirrors of the backend's slot codes (ops must not import the backend:
# the backend imports ops).
EMPTY = 0
PROPOSED = 1
CHOSEN = 2
NO_VALUE = -1
NOOP_VALUE = -2
AMS_FLOOR = -(2**14)

_SOURCE = "frankenpaxos_tpu_torch/csrc/multipaxos.cu"


# ---------------------------------------------------------------------------
# Plain versions (the specification the kernels are held against)
# ---------------------------------------------------------------------------


def _ord_of_pos(head: torch.Tensor, W: int) -> torch.Tensor:
    w_iota = torch.arange(W, dtype=torch.int32, device=head.device)
    return (w_iota[None, :] - head[:, None]) % W  # torch % is floor mod


def reference_vote_quorum(
    p2a_off,  # [A, G, W] offset clocks (0 = arrives now)
    acc_round,  # [A, G] promised rounds
    leader_round,  # [G]
    slot_value,  # [G, W]
    vote_round,  # [A, G, W] (-1 = no vote)
    vote_value,  # [A, G, W]
    p2b_off,  # [A, G, W] offset clocks (INF16 = none pending)
    p2b_lat,  # [A, G, W] sampled latencies (clock dtype)
    p2b_delivered,  # [A, G, W] bool
    head,  # [G] ring heads (max_ord's ordinal origin)
):
    """Tick steps 1-2: acceptors vote on Phase2a arrivals, Phase2b
    arrivals are scheduled, per-slot quorums and Phase2b sends are
    counted, and each acceptor's max voted ring ordinal this tick is
    reported (AMS_FLOOR when it cast none). Returns ``(vote_round,
    vote_value, p2b_off, acc_round, nvotes, nsends, max_ord)``."""
    W = p2a_off.shape[2]
    lr = leader_round[None, :, None]  # [1, G, 1]
    arrived = p2a_off == 0
    may_vote = arrived & (lr >= acc_round[:, :, None])
    new_vote_round = torch.where(may_vote, lr, vote_round)
    new_vote_value = torch.where(may_vote, slot_value[None, :, :], vote_value)
    sends = may_vote & p2b_delivered
    new_p2b = torch.where(sends, torch.minimum(p2b_off, p2b_lat), p2b_off)
    lr_voted = torch.where(may_vote, lr, torch.full_like(lr, -1))
    new_acc_round = torch.maximum(acc_round, torch.amax(lr_voted, dim=2))
    votes_in = (new_p2b <= 0) & (new_vote_round == lr)
    nvotes = votes_in.sum(dim=0, dtype=torch.int32)  # [G, W]
    nsends = sends.sum(dim=0, dtype=torch.int32)  # [G, W]
    ord_of_pos = _ord_of_pos(head, W)
    max_ord = torch.amax(
        torch.where(
            may_vote,
            ord_of_pos[None, :, :],
            torch.full_like(ord_of_pos, AMS_FLOOR)[None],
        ),
        dim=2,
    )  # [A, G]
    return (
        new_vote_round, new_vote_value, new_p2b, new_acc_round, nvotes,
        nsends, max_ord,
    )


def reference_mp_dispatch(
    status,  # [G, W] int8
    slot_value,  # [G, W]
    propose_tick,  # [G, W] absolute ticks
    last_send,  # [G, W] absolute ticks
    chosen_tick,  # [G, W] absolute ticks
    chosen_round,  # [G, W] round dtype
    chosen_value,  # [G, W]
    replica_arrival,  # [G, W] absolute ticks
    p2a_off,  # [A, G, W] offset clocks
    p2b_off,  # [A, G, W] offset clocks
    vote_round,  # [A, G, W]
    vote_value,  # [A, G, W]
    nvotes,  # [G, W] int32 (vote-plane output)
    head,  # [G]
    next_slot,  # [G]
    leader_round,  # [G]
    cap,  # [G] int32: proposal budget
    retry_ok,  # [G] bool
    send_ok,  # [A, G, W] bool: thrifty quorum member AND delivered
    retry_deliv,  # [A, G, W] bool
    p2a_lat,  # [A, G, W] clock dtype
    retry_lat,  # [A, G, W] clock dtype
    rep_lat,  # [G, W] int32
    group_ids,  # [G] int32 global group ids (fresh proposal values)
    t,  # current tick (int)
    *,
    f: int,
    retry_timeout: int,
    num_groups: int,
):
    """Tick steps 2-5: quorum -> Chosen, commit latency, the
    contiguous-prefix commit watermark with all retire-clears, leader
    proposals into the freed window with their Phase2a fan-out, and
    timeout resends. Returns the JAX twin's 21-tuple."""
    G, W = num_groups, status.shape[1]
    w_iota = torch.arange(W, dtype=torch.int32, device=status.device)
    newly_chosen = (status == PROPOSED) & (nvotes >= f + 1)
    chosen_tick = torch.where(newly_chosen, t, chosen_tick)
    chosen_round = torch.where(
        newly_chosen, leader_round[:, None], chosen_round
    )
    chosen_value = torch.where(newly_chosen, slot_value, chosen_value)
    replica_arrival = torch.where(
        newly_chosen, t + rep_lat, replica_arrival
    )
    status = torch.where(newly_chosen, CHOSEN, status)
    latency = torch.where(
        newly_chosen, t - propose_tick, torch.zeros_like(propose_tick)
    )

    ord_of_pos = (w_iota[None, :] - head[:, None]) % W  # [G, W]
    executable = (
        (status == CHOSEN)
        & (replica_arrival <= t)
        & (ord_of_pos < (next_slot - head)[:, None])
    )
    n_retire, retire_mask = ring_retire_pos(executable, ord_of_pos)
    new_head = head + n_retire

    status = torch.where(retire_mask, EMPTY, status)
    slot_value = torch.where(retire_mask, NO_VALUE, slot_value)
    chosen_tick = torch.where(retire_mask, INF, chosen_tick)
    chosen_round = torch.where(retire_mask, -1, chosen_round)
    chosen_value = torch.where(retire_mask, NO_VALUE, chosen_value)
    replica_arrival = torch.where(retire_mask, INF, replica_arrival)
    propose_tick = torch.where(retire_mask, INF, propose_tick)
    last_send = torch.where(retire_mask, INF, last_send)
    p2a_off = torch.where(retire_mask[None, :, :], INF16, p2a_off)
    p2b_off = torch.where(retire_mask[None, :, :], INF16, p2b_off)
    vote_round = torch.where(retire_mask[None, :, :], -1, vote_round)
    vote_value = torch.where(retire_mask[None, :, :], NO_VALUE, vote_value)

    space = W - (next_slot - new_head)  # [G]
    count = torch.minimum(cap, space)
    delta = (w_iota[None, :] - next_slot[:, None]) % W
    is_new = delta < count[:, None]
    new_next = next_slot + count
    status = torch.where(is_new, PROPOSED, status)
    g_ids = group_ids[:, None]
    new_value = ((next_slot[:, None] + delta) * G + g_ids) & 0x7FFFFFFF
    slot_value = torch.where(is_new, new_value, slot_value)
    propose_tick = torch.where(is_new, t, propose_tick)
    last_send = torch.where(is_new, t, last_send)
    p2a_off = torch.where(is_new[None, :, :] & send_ok, p2a_lat, p2a_off)

    timed_out = (
        (status == PROPOSED)
        & (t - last_send >= retry_timeout)
        & retry_ok[:, None]
    )
    p2a_off = torch.where(
        timed_out[None, :, :] & retry_deliv, retry_lat, p2a_off
    )
    last_send = torch.where(timed_out, t, last_send)
    return (
        status, slot_value, propose_tick, last_send,
        chosen_tick, chosen_round, chosen_value, replica_arrival,
        p2a_off, p2b_off, vote_round, vote_value,
        new_head, new_next, count.to(torch.int32), n_retire.to(torch.int32),
        newly_chosen, retire_mask, is_new, timed_out, latency,
    )


def reference_fused_tick(
    p2a_off, acc_round, leader_round, slot_value,
    vote_round, vote_value, p2b_off, p2b_lat, p2b_delivered, head,
    status, propose_tick, last_send, chosen_tick,
    chosen_round, chosen_value, replica_arrival, next_slot, cap, retry_ok,
    send_ok, retry_deliv, p2a_lat, retry_lat, rep_lat, group_ids, t,
    *,
    f: int,
    retry_timeout: int,
    num_groups: int,
    age: bool,
):
    """Exactly the multi-plane path: optional clock aging, then
    :func:`reference_vote_quorum`, then :func:`reference_mp_dispatch`.
    Returns the 21 dispatch outputs plus ``(acc_round, nsends,
    max_ord)`` from the vote plane."""
    if age:
        p2a_off = age_clock(p2a_off)
        p2b_off = age_clock(p2b_off)
    vr, vv, p2b, accr, nvotes, nsends, max_ord = reference_vote_quorum(
        p2a_off, acc_round, leader_round, slot_value, vote_round,
        vote_value, p2b_off, p2b_lat, p2b_delivered, head,
    )
    outs = reference_mp_dispatch(
        status, slot_value, propose_tick, last_send,
        chosen_tick, chosen_round, chosen_value, replica_arrival,
        p2a_off, p2b, vr, vv,
        nvotes, head, next_slot, leader_round, cap, retry_ok,
        send_ok, retry_deliv, p2a_lat, retry_lat, rep_lat, group_ids, t,
        f=f, retry_timeout=retry_timeout, num_groups=num_groups,
    )
    return (*outs, accr, nsends, max_ord)


def reference_p1_promise(
    status,  # [G, W] int8
    vote_round,  # [A, G, W]
    vote_value,  # [A, G, W]
    slot_value,  # [G, W]
    p2a_off,  # [A, G, W] offset clocks
    p2b_off,  # [A, G, W] offset clocks
    last_send,  # [G, W] absolute ticks
    mask,  # [G] bool: groups repairing now
    learned,  # [A, G] bool: acceptors whose Phase1b arrived
    lat,  # [A, G, W] re-send latencies (clock dtype)
    t,  # current tick (int)
):
    """Masked phase-1 log repair: every in-flight slot of a masked group
    adopts the safe value (the value of the max-round vote among the
    LEARNED acceptors, the first such acceptor on a tie, as ``argmax``
    breaks it), or a noop when no learned acceptor voted, and is
    re-proposed to the full group; its pending Phase2bs clear. Returns
    ``(slot_value, p2a_off, p2b_off, last_send)``."""
    A = vote_round.shape[0]
    in_flight = (status == PROPOSED) & mask[:, None]  # [G, W]
    vr = torch.where(
        learned[:, :, None], vote_round, torch.full_like(vote_round, -1)
    )
    # First-max scan over the acceptor axis: strict > keeps the first.
    best_r, best_v = vr[0], vote_value[0]
    for a in range(1, A):
        upd = vr[a] > best_r
        best_r = torch.where(upd, vr[a], best_r)
        best_v = torch.where(upd, vote_value[a], best_v)
    safe_value = torch.where(best_r >= 0, best_v, NOOP_VALUE)
    new_slot_value = torch.where(in_flight, safe_value, slot_value)
    new_p2a = torch.where(in_flight[None, :, :], lat, p2a_off)
    new_p2b = torch.where(in_flight[None, :, :], INF16, p2b_off)
    new_last_send = torch.where(in_flight, t, last_send)
    return new_slot_value, new_p2a, new_p2b, new_last_send


def p1_promise_needed_bytes(args) -> int:
    """The bytes :func:`reference_p1_promise` must move on these inputs
    (its positional arguments, ``t`` last): every output once, the mask,
    and of the inputs only what decides an output. A masked group needs
    its status row and learned bits; its in-flight slots need their
    re-send latencies, the vote rounds of the learned acceptors and the
    winning vote's value where one exists; every other slot needs its
    carried slot value, send tick and clocks. An unmasked group needs no
    status: all of it copies through."""
    status, vote_round, _, _, _, _, _, mask, learned, _, _ = args
    A, G, W = vote_round.shape
    in_flight = (status == PROPOSED) & mask[:, None]  # [G, W]
    n_in = int(in_flight.sum())
    seen = learned[:, :, None] & (vote_round >= 0)  # [A, G, W]
    n_learned_in = int((learned[:, :, None] & in_flight[None]).sum())
    n_voted = int((in_flight & seen.any(dim=0)).sum())
    n_masked = int(mask.sum())
    outs = G * W * 8 + A * G * W * 4
    return (
        G + n_masked * (W + A)
        + n_in * A * 2 + n_learned_in * 2 + n_voted * 4
        + (G * W - n_in) * (8 + A * 4)
        + outs
    )


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

# Pointer slots of the kernels' argument block, in the order of the
# `Slot` enum of csrc/multipaxos.cu.
_PTR_SLOTS = (
    "p2a", "accr", "lr", "sv", "vr", "vv", "p2b", "p2b_lat", "deliv", "head",
    "status", "pt", "ls", "ct", "cr", "cv", "ra", "next", "cap", "rok",
    "gids", "sok", "rdel", "p2a_lat", "retry_lat", "rep_lat", "nvotes_in",
    "o_status", "o_sv", "o_pt", "o_ls", "o_ct", "o_cr", "o_cv", "o_ra",
    "o_p2a", "o_p2b", "o_vr", "o_vv",
    "o_head", "o_next", "o_count", "o_nret",
    "o_newly", "o_retire", "o_isnew", "o_timed", "o_lat",
    "o_accr", "o_nvotes", "o_nsends", "o_maxord",
    "mask", "learned", "p1_lat",
)
_WHICH = {
    "multipaxos_fused_tick": 0,
    "multipaxos_vote_quorum": 1,
    "multipaxos_dispatch": 2,
    "multipaxos_p1_promise": 3,
}

# Expected dtype per input slot (the State's dtype policy).
_I8, _I16, _I32, _B = torch.int8, torch.int16, torch.int32, torch.bool
_IN_DTYPES = {
    "p2a": _I16, "accr": _I16, "lr": _I16, "sv": _I32, "vr": _I16,
    "vv": _I32, "p2b": _I16, "p2b_lat": _I16, "deliv": _B, "head": _I32,
    "status": _I8, "pt": _I32, "ls": _I32, "ct": _I32, "cr": _I16,
    "cv": _I32, "ra": _I32, "next": _I32, "cap": _I32, "rok": _B,
    "gids": _I32, "sok": _B, "rdel": _B, "p2a_lat": _I16,
    "retry_lat": _I16, "rep_lat": _I32, "nvotes_in": _I32,
    "mask": _B, "learned": _B, "p1_lat": _I16,
}


def _check_inputs(name: str, ins: dict, A: int, G: int, W: int) -> None:
    shapes = {
        "agw": (A, G, W), "ag": (A, G), "gw": (G, W), "g": (G,),
    }
    kind = {
        "p2a": "agw", "vr": "agw", "vv": "agw", "p2b": "agw",
        "p2b_lat": "agw", "deliv": "agw", "sok": "agw", "rdel": "agw",
        "p2a_lat": "agw", "retry_lat": "agw", "p1_lat": "agw",
        "accr": "ag", "learned": "ag",
        "sv": "gw", "status": "gw", "pt": "gw", "ls": "gw", "ct": "gw",
        "cr": "gw", "cv": "gw", "ra": "gw", "rep_lat": "gw",
        "nvotes_in": "gw", "lr": "g", "head": "g", "next": "g",
        "cap": "g", "rok": "g", "gids": "g", "mask": "g",
    }
    for slot, x in ins.items():
        want = shapes[kind[slot]]
        if tuple(x.shape) != want:
            raise ValueError(
                f"{name}: {slot} has shape {tuple(x.shape)}, want {want}"
            )
        if x.dtype != _IN_DTYPES[slot]:
            raise TypeError(
                f"{name}: {slot} has dtype {x.dtype}, want "
                f"{_IN_DTYPES[slot]} (the kernels take the State's dtype "
                f"policy only)"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name}: {slot} is not contiguous")


def _prepare(
    name: str,
    ins: dict,
    outs: dict,
    *,
    A: int,
    G: int,
    W: int,
    t: int,
    f: int = 1,
    retry_timeout: int = 0,
    num_groups: int = 1,
    age: bool = False,
    block: int = 0,
    route: str = "",
) -> Callable[[], None]:
    """Check the inputs and pack the launch arguments; returns the launch
    itself (which loads the library, counts the launch and raises on a
    refused launch), so a caller can time the kernel apart from the
    checks and allocations around it. ``route``: the phase-1 kernel's
    (:func:`p1_promise_route`), counted per route; the other kernels
    pick their instantiation from A and W. The launch carries ``route``
    and ``packed``, the library call's arguments (``harness/
    vector_race.py`` calls another build of the source with them)."""
    from frankenpaxos_tpu_torch.ops import _build

    _check_inputs(name, ins, A, G, W)
    t = int(t)
    if not -(2**31) <= t < 2**31:
        raise ValueError(f"{name}: tick {t} outside int32")
    gpb = block if block > 0 else max(1, 256 // W)
    gpb = max(1, min(gpb, 1024 // W))
    tensors = {**ins, **outs}
    ptrs = (ctypes.c_void_p * len(_PTR_SLOTS))(
        *[
            tensors[s].data_ptr() if s in tensors else None
            for s in _PTR_SLOTS
        ]
    )
    ints = (ctypes.c_int * 9)(
        G, W, t, f, retry_timeout, num_groups, int(bool(age)), gpb,
        registry.ROUTES.index(route) if route else 0,
    )
    device = next(iter(ins.values())).device
    which = _WHICH[name]

    def launch() -> None:
        lib = _build.kernel_lib("fpx_mp", len(_PTR_SLOTS))
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fpx_mp_launch(which, A, ptrs, ints, stream)
        if err != 0:
            raise RuntimeError(
                f"{name}: kernel launch failed: "
                f"{lib.fpx_error_string(err).decode()} (cuda error {err})"
            )
        registry.count_launch(name, route)

    launch.route = route
    launch.packed = (which, A, ptrs, ints)
    return launch


def p1_promise_route(*args) -> str:
    """The phase-1 kernel's route for the plane's arguments (those of
    :func:`fused_p1_promise`, ``t`` last): "vector" when W % 8 == 0 and
    every tensor is 16-byte aligned (8 slots a thread, 16-byte loads);
    else "general" (a thread a slot, any A and W). The kernel refuses the
    vector route where its conditions do not hold."""
    W = args[1].shape[2]
    if W % 8 == 0 and registry.aligned16(args):
        return "vector"
    return "general"


def _empty(shape, dtype, like):
    return torch.empty(shape, dtype=dtype, device=like.device)


def fused_vote_quorum(
    p2a_off, acc_round, leader_round, slot_value,
    vote_round, vote_value, p2b_off, p2b_lat, p2b_delivered, head,
    block: int = 0,
):
    """:func:`reference_vote_quorum` as one CUDA kernel on the card (the
    plain version on the CPU). Replaces the Pallas ``fused_vote_quorum``
    (frankenpaxos_tpu/ops/multipaxos.py:216). Bound by bytes: ~64 MB at
    the flagship shape (3, 3334, 256), ~19 us at 3.35 TB/s. Bit-exact:
    integer work only, ring ordinals floored (module docstring)."""
    args = (
        p2a_off, acc_round, leader_round, slot_value, vote_round,
        vote_value, p2b_off, p2b_lat, p2b_delivered, head,
    )
    if on_cpu(args):
        return reference_vote_quorum(*args)
    launch, out = _vote_quorum_kernel(*args, block=block)
    launch()
    return out


def _vote_quorum_kernel(
    p2a_off, acc_round, leader_round, slot_value,
    vote_round, vote_value, p2b_off, p2b_lat, p2b_delivered, head,
    block: int = 0,
):
    A, G, W = p2a_off.shape
    ins = dict(
        p2a=p2a_off, accr=acc_round, lr=leader_round, sv=slot_value,
        vr=vote_round, vv=vote_value, p2b=p2b_off, p2b_lat=p2b_lat,
        deliv=p2b_delivered, head=head,
    )
    x = p2a_off
    outs = dict(
        o_vr=_empty((A, G, W), vote_round.dtype, x),
        o_vv=_empty((A, G, W), vote_value.dtype, x),
        o_p2b=_empty((A, G, W), p2b_off.dtype, x),
        o_accr=_empty((A, G), acc_round.dtype, x),
        o_nvotes=_empty((G, W), torch.int32, x),
        o_nsends=_empty((G, W), torch.int32, x),
        o_maxord=_empty((A, G), torch.int32, x),
    )
    launch = _prepare(
        "multipaxos_vote_quorum", ins, outs, A=A, G=G, W=W, t=0,
        block=block,
    )
    return launch, (
        outs["o_vr"], outs["o_vv"], outs["o_p2b"], outs["o_accr"],
        outs["o_nvotes"], outs["o_nsends"], outs["o_maxord"],
    )


def _dispatch_outs(A, G, W, x, status, slot_value, chosen_round, p2a_off,
                   p2b_off, vote_round, vote_value):
    i32 = torch.int32
    return dict(
        o_status=_empty((G, W), status.dtype, x),
        o_sv=_empty((G, W), slot_value.dtype, x),
        o_pt=_empty((G, W), i32, x),
        o_ls=_empty((G, W), i32, x),
        o_ct=_empty((G, W), i32, x),
        o_cr=_empty((G, W), chosen_round.dtype, x),
        o_cv=_empty((G, W), i32, x),
        o_ra=_empty((G, W), i32, x),
        o_p2a=_empty((A, G, W), p2a_off.dtype, x),
        o_p2b=_empty((A, G, W), p2b_off.dtype, x),
        o_vr=_empty((A, G, W), vote_round.dtype, x),
        o_vv=_empty((A, G, W), vote_value.dtype, x),
        o_head=_empty((G,), i32, x),
        o_next=_empty((G,), i32, x),
        o_count=_empty((G,), i32, x),
        o_nret=_empty((G,), i32, x),
        o_newly=_empty((G, W), torch.bool, x),
        o_retire=_empty((G, W), torch.bool, x),
        o_isnew=_empty((G, W), torch.bool, x),
        o_timed=_empty((G, W), torch.bool, x),
        o_lat=_empty((G, W), i32, x),
    )


_DISPATCH_ORDER = (
    "o_status", "o_sv", "o_pt", "o_ls", "o_ct", "o_cr", "o_cv", "o_ra",
    "o_p2a", "o_p2b", "o_vr", "o_vv",
    "o_head", "o_next", "o_count", "o_nret",
    "o_newly", "o_retire", "o_isnew", "o_timed", "o_lat",
)


def fused_mp_dispatch(
    status, slot_value, propose_tick, last_send,
    chosen_tick, chosen_round, chosen_value, replica_arrival,
    p2a_off, p2b_off, vote_round, vote_value,
    nvotes, head, next_slot, leader_round, cap, retry_ok,
    send_ok, retry_deliv, p2a_lat, retry_lat, rep_lat, group_ids, t,
    block: int = 0,
    *,
    f: int = 1,
    retry_timeout: int = 16,
    num_groups: int = 1,
):
    """:func:`reference_mp_dispatch` as one CUDA kernel on the card (the
    plain version on the CPU). Replaces the Pallas ``fused_mp_dispatch``
    (frankenpaxos_tpu/ops/multipaxos.py:738). Bound by bytes: ~126 MB at
    the flagship shape, ~38 us at 3.35 TB/s. Bit-exact: the ring
    ordinals are floored and the fresh value ``((next + delta) * G + g)
    & 0x7FFFFFFF`` wraps in uint32 (module docstring)."""
    args = (
        status, slot_value, propose_tick, last_send,
        chosen_tick, chosen_round, chosen_value, replica_arrival,
        p2a_off, p2b_off, vote_round, vote_value,
        nvotes, head, next_slot, leader_round, cap, retry_ok,
        send_ok, retry_deliv, p2a_lat, retry_lat, rep_lat, group_ids,
    )
    statics = dict(f=f, retry_timeout=retry_timeout, num_groups=num_groups)
    if on_cpu(args):
        return reference_mp_dispatch(*args, t, **statics)
    launch, out = _mp_dispatch_kernel(*args, t, block, **statics)
    launch()
    return out


def _mp_dispatch_kernel(
    status, slot_value, propose_tick, last_send,
    chosen_tick, chosen_round, chosen_value, replica_arrival,
    p2a_off, p2b_off, vote_round, vote_value,
    nvotes, head, next_slot, leader_round, cap, retry_ok,
    send_ok, retry_deliv, p2a_lat, retry_lat, rep_lat, group_ids, t,
    block: int = 0,
    *,
    f: int,
    retry_timeout: int,
    num_groups: int,
):
    A, G, W = p2a_off.shape
    ins = dict(
        status=status, sv=slot_value, pt=propose_tick, ls=last_send,
        ct=chosen_tick, cr=chosen_round, cv=chosen_value,
        ra=replica_arrival, p2a=p2a_off, p2b=p2b_off, vr=vote_round,
        vv=vote_value, nvotes_in=nvotes, head=head, next=next_slot,
        lr=leader_round, cap=cap, rok=retry_ok, sok=send_ok,
        rdel=retry_deliv, p2a_lat=p2a_lat, retry_lat=retry_lat,
        rep_lat=rep_lat, gids=group_ids,
    )
    outs = _dispatch_outs(
        A, G, W, p2a_off, status, slot_value, chosen_round, p2a_off,
        p2b_off, vote_round, vote_value,
    )
    launch = _prepare(
        "multipaxos_dispatch", ins, outs, A=A, G=G, W=W, t=t, f=f,
        retry_timeout=retry_timeout, num_groups=num_groups, block=block,
    )
    return launch, tuple(outs[k] for k in _DISPATCH_ORDER)


def fused_tick(
    p2a_off, acc_round, leader_round, slot_value,
    vote_round, vote_value, p2b_off, p2b_lat, p2b_delivered, head,
    status, propose_tick, last_send, chosen_tick,
    chosen_round, chosen_value, replica_arrival, next_slot, cap, retry_ok,
    send_ok, retry_deliv, p2a_lat, retry_lat, rep_lat, group_ids, t,
    block: int = 0,
    *,
    f: int = 1,
    retry_timeout: int = 16,
    num_groups: int = 1,
    age: bool = True,
):
    """:func:`reference_fused_tick` as one CUDA kernel on the card (the
    plain version on the CPU): the whole tick hot path in one launch.
    Replaces the Pallas ``fused_tick``
    (frankenpaxos_tpu/ops/multipaxos.py:1029). Bound by bytes: ~134 MB
    at the flagship shape, ~40 us at 3.35 TB/s; the vote half's outputs
    stay in registers for the dispatch half. Bit-exact: as for the two
    per-plane kernels, plus int16 clock aging cast back to int16."""
    args = (
        p2a_off, acc_round, leader_round, slot_value,
        vote_round, vote_value, p2b_off, p2b_lat, p2b_delivered, head,
        status, propose_tick, last_send, chosen_tick,
        chosen_round, chosen_value, replica_arrival, next_slot, cap,
        retry_ok, send_ok, retry_deliv, p2a_lat, retry_lat, rep_lat,
        group_ids,
    )
    statics = dict(
        f=f, retry_timeout=retry_timeout, num_groups=num_groups, age=age
    )
    if on_cpu(args):
        return reference_fused_tick(*args, t, **statics)
    launch, out = _fused_tick_kernel(*args, t, block, **statics)
    launch()
    return out


def _fused_tick_kernel(
    p2a_off, acc_round, leader_round, slot_value,
    vote_round, vote_value, p2b_off, p2b_lat, p2b_delivered, head,
    status, propose_tick, last_send, chosen_tick,
    chosen_round, chosen_value, replica_arrival, next_slot, cap, retry_ok,
    send_ok, retry_deliv, p2a_lat, retry_lat, rep_lat, group_ids, t,
    block: int = 0,
    *,
    f: int,
    retry_timeout: int,
    num_groups: int,
    age: bool,
):
    A, G, W = p2a_off.shape
    ins = dict(
        p2a=p2a_off, accr=acc_round, lr=leader_round, sv=slot_value,
        vr=vote_round, vv=vote_value, p2b=p2b_off, p2b_lat=p2b_lat,
        deliv=p2b_delivered, head=head, status=status, pt=propose_tick,
        ls=last_send, ct=chosen_tick, cr=chosen_round, cv=chosen_value,
        ra=replica_arrival, next=next_slot, cap=cap, rok=retry_ok,
        sok=send_ok, rdel=retry_deliv, p2a_lat=p2a_lat,
        retry_lat=retry_lat, rep_lat=rep_lat, gids=group_ids,
    )
    x = p2a_off
    outs = _dispatch_outs(
        A, G, W, x, status, slot_value, chosen_round, p2a_off, p2b_off,
        vote_round, vote_value,
    )
    outs.update(
        o_accr=_empty((A, G), acc_round.dtype, x),
        o_nsends=_empty((G, W), torch.int32, x),
        o_maxord=_empty((A, G), torch.int32, x),
    )
    launch = _prepare(
        "multipaxos_fused_tick", ins, outs, A=A, G=G, W=W, t=t, f=f,
        retry_timeout=retry_timeout, num_groups=num_groups, age=age,
        block=block,
    )
    return launch, tuple(outs[k] for k in _DISPATCH_ORDER) + (
        outs["o_accr"], outs["o_nsends"], outs["o_maxord"],
    )


def fused_p1_promise(
    status, vote_round, vote_value, slot_value, p2a_off, p2b_off,
    last_send, mask, learned, lat, t,
    block: int = 0,
):
    """:func:`reference_p1_promise` as one CUDA kernel on the card (the
    plain version on the CPU). Replaces the Pallas ``fused_p1_promise``
    (frankenpaxos_tpu/ops/multipaxos.py:385). Bound by bytes
    (:func:`p1_promise_needed_bytes`: ~34 MB at the flagship shape, ~10
    us at 3.35 TB/s). On the vector route (:func:`p1_promise_route`) a
    thread owns 8 slots of one group and reads the group's mask once: an
    unmasked group is a 16-byte copy that never reads the status, a
    masked group reads its rows in one trip and the winners' vote values
    in a second. Bit-exact: a first-max scan with strict ``>``."""
    args = (
        status, vote_round, vote_value, slot_value, p2a_off, p2b_off,
        last_send, mask, learned, lat,
    )
    if on_cpu(args):
        return reference_p1_promise(*args, t)
    launch, out = _p1_promise_kernel(*args, t, block)
    launch()
    return out


def _p1_promise_kernel(
    status, vote_round, vote_value, slot_value, p2a_off, p2b_off,
    last_send, mask, learned, lat, t,
    block: int = 0,
):
    A, G, W = vote_round.shape
    ins = dict(
        status=status, vr=vote_round, vv=vote_value, sv=slot_value,
        p2a=p2a_off, p2b=p2b_off, ls=last_send, mask=mask,
        learned=learned, p1_lat=lat,
    )
    x = vote_round
    outs = dict(
        o_sv=_empty((G, W), slot_value.dtype, x),
        o_p2a=_empty((A, G, W), p2a_off.dtype, x),
        o_p2b=_empty((A, G, W), p2b_off.dtype, x),
        o_ls=_empty((G, W), last_send.dtype, x),
    )
    launch = _prepare(
        "multipaxos_p1_promise", ins, outs, A=A, G=G, W=W, t=t, block=block,
        route=p1_promise_route(
            status, vote_round, vote_value, slot_value, p2a_off, p2b_off,
            last_send, mask, learned, lat,
        ),
    )
    return launch, (outs["o_sv"], outs["o_p2a"], outs["o_p2b"], outs["o_ls"])


_KERNELS = {
    "multipaxos_vote_quorum": _vote_quorum_kernel,
    "multipaxos_dispatch": _mp_dispatch_kernel,
    "multipaxos_fused_tick": _fused_tick_kernel,
    "multipaxos_p1_promise": _p1_promise_kernel,
}


def prepared_launch(plane: str, *args, **statics):
    """For timing a kernel apart from its wrapper: checks the tensors
    ``args`` (the wrapper's arguments), allocates the outputs and returns
    ``(launch, outputs)``; each ``launch()`` runs the kernel once into
    those outputs (and counts as a launch). Nothing here needs the card:
    on CPU tensors it runs the wrapper's checks alone."""
    return _KERNELS[plane](*args, **statics)


# ---------------------------------------------------------------------------
# Example inputs: numpy arrays in the State's dtype policy, from a seed.
# The tests hand the same arrays to the JAX planes and to these; the
# chip check holds each kernel against its plain version on them.
# ---------------------------------------------------------------------------

VOTE_QUORUM_OUTS = (
    "vote_round", "vote_value", "p2b", "acc_round", "nvotes", "nsends",
    "max_ord",
)
MP_DISPATCH_OUTS = (
    "status", "slot_value", "propose_tick", "last_send",
    "chosen_tick", "chosen_round", "chosen_value", "replica_arrival",
    "p2a", "p2b", "vote_round", "vote_value",
    "head", "next_slot", "count", "n_retire",
    "newly_chosen", "retire_mask", "is_new", "timed_out", "latency",
)
FUSED_TICK_OUTS = MP_DISPATCH_OUTS + ("acc_round", "nsends", "max_ord")
P1_PROMISE_OUTS = ("slot_value", "p2a", "p2b", "last_send")
P1_PROMISE_CASES = ("random", "noop", "ties", "sparse")


def _np_clock(rng, shape, p=0.3):
    """Offset clock: INF16 (never) or an offset in [-1, 5)."""
    return np.where(
        rng.random(shape) < p, rng.integers(-1, 5, shape), INF16
    ).astype(np.int16)


def example_vote_quorum_args(rng, A, G, W):
    p2a = _np_clock(rng, (A, G, W))
    acc_round = rng.integers(0, 3, (A, G)).astype(np.int16)
    leader_round = rng.integers(0, 3, (G,)).astype(np.int16)
    slot_value = rng.integers(0, 1000, (G, W)).astype(np.int32)
    vote_round = rng.integers(-1, 3, (A, G, W)).astype(np.int16)
    vote_value = np.where(
        vote_round >= 0, rng.integers(0, 1000, (A, G, W)), -1
    ).astype(np.int32)
    p2b = np.where(
        vote_round >= 0, _np_clock(rng, (A, G, W), p=0.7), INF16
    ).astype(np.int16)
    lat = rng.integers(1, 4, (A, G, W)).astype(np.int16)
    delivered = rng.random((A, G, W)) < 0.9
    # Heads run past W so the ring ordinals wrap.
    head = rng.integers(0, 100, (G,)).astype(np.int32)
    return (
        p2a, acc_round, leader_round, slot_value,
        vote_round, vote_value, p2b, lat, delivered, head,
    )


def example_mp_dispatch_args(rng, A, G, W, t=33):
    status = rng.integers(0, 3, (G, W)).astype(np.int8)
    live = status > 0
    chosen = status == CHOSEN
    slot_value = np.where(live, rng.integers(0, 1000, (G, W)), -1)
    propose_tick = np.where(live, rng.integers(0, 30, (G, W)), INF)
    last_send = np.where(live, rng.integers(0, 33, (G, W)), INF)
    chosen_tick = np.where(chosen, rng.integers(0, 33, (G, W)), INF)
    chosen_round = np.where(chosen, rng.integers(0, 3, (G, W)), -1)
    chosen_value = np.where(chosen, slot_value, -1)
    replica_arrival = np.where(chosen, rng.integers(30, 40, (G, W)), INF)
    p2a = _np_clock(rng, (A, G, W))
    p2b = _np_clock(rng, (A, G, W))
    vote_round = rng.integers(-1, 3, (A, G, W)).astype(np.int16)
    vote_value = np.where(
        vote_round >= 0, rng.integers(0, 1000, (A, G, W)), -1
    )
    nvotes = rng.integers(0, A + 1, (G, W))
    head = rng.integers(0, 100, (G,))
    next_slot = head + rng.integers(0, W + 1, (G,))
    leader_round = rng.integers(0, 3, (G,)).astype(np.int16)
    cap = rng.integers(0, 5, (G,))
    retry_ok = rng.random((G,)) < 0.8
    send_ok = rng.random((A, G, W)) < 0.6
    retry_deliv = rng.random((A, G, W)) < 0.9
    p2a_lat = rng.integers(1, 4, (A, G, W)).astype(np.int16)
    retry_lat = rng.integers(1, 4, (A, G, W)).astype(np.int16)
    rep_lat = rng.integers(1, 4, (G, W))
    i32 = np.int32
    return (
        status, slot_value.astype(i32), propose_tick.astype(i32),
        last_send.astype(i32), chosen_tick.astype(i32),
        chosen_round.astype(np.int16), chosen_value.astype(i32),
        replica_arrival.astype(i32),
        p2a, p2b, vote_round, vote_value.astype(i32),
        nvotes.astype(i32), head.astype(i32), next_slot.astype(i32),
        leader_round, cap.astype(i32), retry_ok,
        send_ok, retry_deliv, p2a_lat, retry_lat, rep_lat.astype(i32),
        np.arange(G, dtype=i32), t,
    )


def example_fused_tick_args(rng, A, G, W, age=True, t=33):
    """The vote-plane args plus the dispatch-only args. With ``age`` the
    clocks are drawn one tick early (+1), so the in-kernel aging lands
    the same arrivals."""
    (p2a, acc_round, leader_round, slot_value, vote_round, vote_value,
     p2b, p2b_lat, delivered, _head) = example_vote_quorum_args(rng, A, G, W)
    if age:
        p2a = np.where(p2a == INF16, INF16, p2a + 1).astype(np.int16)
        p2b = np.where(p2b == INF16, INF16, p2b + 1).astype(np.int16)
    d = example_mp_dispatch_args(rng, A, G, W, t=t)
    (status, _sv, propose_tick, last_send, chosen_tick, chosen_round,
     chosen_value, replica_arrival, _p2a, _p2b, _vr, _vv, _nvotes, head,
     next_slot, _lr, cap, retry_ok, send_ok, retry_deliv, p2a_lat,
     retry_lat, rep_lat, group_ids, t) = d
    return (
        p2a, acc_round, leader_round, slot_value, vote_round, vote_value,
        p2b, p2b_lat, delivered, head,
        status, propose_tick, last_send, chosen_tick, chosen_round,
        chosen_value, replica_arrival, next_slot, cap, retry_ok,
        send_ok, retry_deliv, p2a_lat, retry_lat, rep_lat, group_ids, t,
    )


def example_p1_promise_args(rng, A, G, W, case="random", t=40):
    """Phase-1 plane inputs. ``case``: "random" (mixed statuses, masks
    and learned acceptors); "noop" (every group masked, every slot in
    flight, no acceptor learned: every slot repairs to a noop); "ties"
    (every acceptor voted in the same round per slot, with different
    values, so the first learned acceptor's value must win); "sparse"
    (the failover path's inputs: about 1% of the groups masked, at least
    one, with every acceptor learned, as an election reads them)."""
    status = rng.integers(0, 3, (G, W)).astype(np.int8)
    vote_round = rng.integers(-1, 3, (A, G, W)).astype(np.int16)
    mask = rng.random((G,)) < 0.6
    learned = rng.random((A, G)) < 0.7
    if case == "noop":
        status = np.full((G, W), PROPOSED, np.int8)
        mask = np.ones((G,), bool)
        learned = np.zeros((A, G), bool)
    elif case == "ties":
        status = np.full((G, W), PROPOSED, np.int8)
        mask = np.ones((G,), bool)
        learned = rng.random((A, G)) < 0.8
        vote_round = np.broadcast_to(
            rng.integers(0, 3, (G, W)), (A, G, W)
        ).astype(np.int16)
    elif case == "sparse":
        mask = rng.random((G,)) < 0.01
        mask[rng.integers(0, G)] = True
        learned = np.ones((A, G), bool)
    elif case != "random":
        raise ValueError(f"unknown case {case!r}")
    vote_value = np.where(
        vote_round >= 0, rng.integers(0, 1000, (A, G, W)), -1
    ).astype(np.int32)
    slot_value = rng.integers(0, 1000, (G, W)).astype(np.int32)
    p2a = _np_clock(rng, (A, G, W))
    p2b = _np_clock(rng, (A, G, W))
    last_send = rng.integers(0, t, (G, W)).astype(np.int32)
    lat = rng.integers(1, 4, (A, G, W)).astype(np.int16)
    return (
        status, vote_round, vote_value, slot_value, p2a, p2b, last_send,
        mask, learned, lat, t,
    )


# ---------------------------------------------------------------------------
# Registration
# ---------------------------------------------------------------------------

registry.register(
    registry.Plane(
        name="multipaxos_vote_quorum",
        backend="multipaxos",
        reference=reference_vote_quorum,
        kernel=fused_vote_quorum,
        source=_SOURCE,
        replaces="frankenpaxos_tpu/ops/multipaxos.py:216 fused_vote_quorum "
        "(pallas_call :278)",
    )
)
registry.register(
    registry.Plane(
        name="multipaxos_dispatch",
        backend="multipaxos",
        reference=reference_mp_dispatch,
        kernel=fused_mp_dispatch,
        source=_SOURCE,
        replaces="frankenpaxos_tpu/ops/multipaxos.py:738 fused_mp_dispatch "
        "(pallas_call :820)",
    )
)
registry.register(
    registry.Plane(
        name="multipaxos_fused_tick",
        backend="multipaxos",
        reference=reference_fused_tick,
        kernel=fused_tick,
        source=_SOURCE,
        replaces="frankenpaxos_tpu/ops/multipaxos.py:1029 fused_tick "
        "(pallas_call :1127)",
    )
)
registry.register(
    registry.Plane(
        name="multipaxos_p1_promise",
        backend="multipaxos",
        reference=reference_p1_promise,
        kernel=fused_p1_promise,
        source=_SOURCE,
        replaces="frankenpaxos_tpu/ops/multipaxos.py:385 fused_p1_promise "
        "(pallas_call :447)",
    )
)
