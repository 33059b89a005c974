"""The Mencius vote plane: its plain PyTorch version and the wrapper of
its hand-written CUDA kernel (``csrc/mencius.cu``).

One plane of ``tpu/mencius_batched.py`` dispatches here: ``mencius_vote``
(:func:`fused_mencius_vote`, replaces the Pallas ``fused_mencius_vote``
at ``frankenpaxos_tpu/ops/mencius.py:81``). It covers tick steps 1-2:
the acceptors of every stripe vote on the Phase2a messages that arrive
now (each leader owns its stripe, so there are no competing rounds),
schedule their Phase2b replies (a min-write where the reply is
delivered), and the per-slot vote count sums the acceptor axis. Skips
(noop range fills) go through this plane as ordinary proposals.

The State is leader-major ``[L, W, A]``: the tiny acceptor axis is the
MINOR one, so a slot's acceptors are ``A`` neighbouring cells.

:func:`reference_mencius_vote` is the plain version, line for line the
JAX reference twin, with its outputs and dtypes. The wrapper runs it when
its tensors lie on the CPU and launches the kernel when they lie on the
card; it never falls back from the card to the plain version.

The kernel has two routes (:func:`mencius_vote_route`): the vector route,
which every configuration of the repo takes (a thread per four cells: a
16-byte load of each int32 plane and a 4-byte load of each bool plane,
every dense load before any store, the slot counts joined in shared
memory), and the general kernel (a thread a slot) for the shapes it does
not take.

Bound: a few integer ops per byte, so bound by the bytes moved. The bytes
the function needs (:func:`mencius_vote_needed_bytes`: every Phase2a and
Phase2b tick, a cell's vote bit where no Phase2a arrives now and its
delivery bit where one does, the latency only where a delivered reply is
scheduled, every output) are 5.16 MB at ``(L, W, A) = (3334, 32, 3)`` on
the kernels line's inputs (1.5 us at 3.35 TB/s). The vector route also
reads the vote bits of the cells whose Phase2a arrives now
(:func:`mencius_vote_route_bytes`, 5.24 MB); every input and output once
is 6.5 MB.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from frankenpaxos_tpu_torch.ops import registry
from frankenpaxos_tpu_torch.ops.registry import on_cpu
from frankenpaxos_tpu_torch.tpu.common import INF, sum32

_SOURCE = "frankenpaxos_tpu_torch/csrc/mencius.cu"
_PLANE = "mencius_vote"

MENCIUS_VOTE_OUTS = ("voted", "p2b_arrival", "nvotes")


# ---------------------------------------------------------------------------
# Plain version (the specification the kernel is held against)
# ---------------------------------------------------------------------------


def reference_mencius_vote(
    p2a_arrival,  # [L, W, A] int32 absolute arrival ticks
    voted,  # [L, W, A] bool
    p2b_arrival,  # [L, W, A] int32 absolute arrival ticks
    p2b_lat,  # [L, W, A] int32 sampled latencies
    p2b_delivered,  # [L, W, A] bool
    t,  # current tick (int)
):
    """Tick steps 1-2 of mencius_batched. Returns ``(voted', p2b_arrival',
    nvotes [L, W] int32)``."""
    arrived = p2a_arrival == t
    new_voted = voted | arrived
    new_p2b = torch.where(
        arrived & p2b_delivered,
        torch.minimum(p2b_arrival, t + p2b_lat),
        p2b_arrival,
    )
    nvotes = sum32((new_p2b <= t) & new_voted, dim=2)
    return new_voted, new_p2b, nvotes


def mencius_vote_needed_bytes(args) -> int:
    """The bytes the plain version's outputs need on these inputs
    (``args``: its positional arguments, ``t`` last): every cell's Phase2a
    and Phase2b tick; the vote bit of each cell whose Phase2a does not
    arrive now and the delivery bit of each cell whose Phase2a does; the
    latency of each of those whose reply is delivered; every output once.
    The outputs depend on no other input cell (the poison test of
    ``tests/test_torch_ops_mencius.py``)."""
    p2a, _, _, _, deliv, t = args
    L, W, A = p2a.shape
    cells, slots = L * W * A, L * W
    arrived = p2a == int(t)
    return (
        cells * 9  # Phase2a tick, Phase2b tick; vote or delivery bit
        + int((arrived & deliv).sum()) * 4  # latencies
        + cells * 5 + slots * 4  # vote bit, Phase2b tick; count
    )


def mencius_vote_route_bytes(args) -> int:
    """The bytes the kernel's vector route moves on these inputs (as
    :func:`mencius_vote_needed_bytes`): it also reads the vote bit of
    each cell whose Phase2a arrives now, with its vector."""
    p2a, t = args[0], args[-1]
    return mencius_vote_needed_bytes(args) + int((p2a == int(t)).sum())


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# The acceptor counts the vector route is built for (csrc/mencius.cu).
VEC_A = (3, 5, 7, 9)


def mencius_vote_route(*args) -> str:
    """The vote kernel's route for the plane's arguments (those of
    :func:`fused_mencius_vote`): "vector" when L * W % 4 == 0, A is in
    VEC_A and every tensor is 16-byte aligned; else "general" (a thread a
    slot, any shape). The vector route runs 32 * A threads a CTA; the
    wrapper's block sizes only the general route's CTAs. The kernel
    refuses the vector route where its conditions do not hold."""
    L, W, A = args[0].shape
    if L * W % 4 == 0 and A in VEC_A and registry.aligned16(args):
        return "vector"
    return "general"


# Pointer slots of the kernel's argument block, in the order of the `Slot`
# enum of csrc/mencius.cu.
_PTR_SLOTS = ("p2a", "voted", "p2b", "lat", "deliv", "o_voted", "o_p2b", "o_nv")
_IN_DTYPES = {
    "p2a": torch.int32, "voted": torch.bool, "p2b": torch.int32,
    "lat": torch.int32, "deliv": torch.bool,
}


def _mencius_vote_kernel(
    p2a_arrival, voted, p2b_arrival, p2b_lat, p2b_delivered, t, block: int = 0
):
    """Check the tensors, pick the route (:func:`mencius_vote_route`),
    allocate the outputs and pack the launch; returns ``(launch,
    outputs)``. The launch loads the CUDA library, so the checks run
    without a card; it carries ``route`` and ``packed``, the library
    call's arguments (``harness/chain_race.py`` calls other builds of the
    source with them)."""
    from frankenpaxos_tpu_torch.ops import _build

    L, W, A = p2a_arrival.shape
    ins = dict(
        p2a=p2a_arrival, voted=voted, p2b=p2b_arrival, lat=p2b_lat,
        deliv=p2b_delivered,
    )
    for slot, x in ins.items():
        if tuple(x.shape) != (L, W, A):
            raise ValueError(
                f"{_PLANE}: {slot} has shape {tuple(x.shape)}, want {(L, W, A)}"
            )
        if x.dtype != _IN_DTYPES[slot]:
            raise TypeError(
                f"{_PLANE}: {slot} has dtype {x.dtype}, want {_IN_DTYPES[slot]}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{_PLANE}: {slot} is not contiguous")
    t = int(t)
    if not -(2**31) <= t < 2**31:
        raise ValueError(f"{_PLANE}: tick {t} outside int32")
    if block and not 32 <= block <= 1024:
        raise ValueError(f"{_PLANE}: block={block} threads, want 32-1024")
    route = mencius_vote_route(*ins.values())
    threads = block or 256

    dev = p2a_arrival.device
    outs = dict(
        o_voted=torch.empty((L, W, A), dtype=torch.bool, device=dev),
        o_p2b=torch.empty((L, W, A), dtype=torch.int32, device=dev),
        o_nv=torch.empty((L, W), dtype=torch.int32, device=dev),
    )
    tensors = {**ins, **outs}
    ptrs = (ctypes.c_void_p * len(_PTR_SLOTS))(
        *[tensors[s].data_ptr() for s in _PTR_SLOTS]
    )
    ints = (ctypes.c_int * 6)(L, W, A, t, threads, registry.ROUTES.index(route))

    def launch() -> None:
        lib = _build.kernel_lib("fpx_mencius", len(_PTR_SLOTS))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fpx_mencius_launch(ptrs, ints, stream)
        if err != 0:
            raise RuntimeError(
                f"{_PLANE}: kernel launch failed: "
                f"{lib.fpx_error_string(err).decode()} (cuda error {err})"
            )
        registry.count_launch(_PLANE, route)

    launch.route = route
    launch.packed = (ptrs, ints)
    return launch, (outs["o_voted"], outs["o_p2b"], outs["o_nv"])


def fused_mencius_vote(
    p2a_arrival, voted, p2b_arrival, p2b_lat, p2b_delivered, t, block: int = 0
):
    """:func:`reference_mencius_vote` as one CUDA kernel on the card (the
    plain version on the CPU). Replaces the Pallas ``fused_mencius_vote``
    (frankenpaxos_tpu/ops/mencius.py:81), on the route of
    :func:`mencius_vote_route`. Bound by bytes: 5.16 MB needed at (3334,
    32, 3). Bit-exact: integer work only, the reply tick added in wrapping
    int32."""
    args = (p2a_arrival, voted, p2b_arrival, p2b_lat, p2b_delivered)
    if on_cpu(args):
        return reference_mencius_vote(*args, t)
    launch, out = _mencius_vote_kernel(*args, t, block)
    launch()
    return out


def prepared_launch(*args, **statics) -> tuple:
    """For timing the kernel apart from its wrapper: checks the tensors
    ``args`` (the wrapper's arguments), picks the route, allocates the
    outputs and returns ``(launch, outputs)``; each ``launch()`` runs the
    kernel once into those outputs (and counts as a launch on its route,
    ``launch.route``). On CPU tensors it runs the wrapper's checks alone:
    only the launch needs the card."""
    return _mencius_vote_kernel(*args, **statics)


# ---------------------------------------------------------------------------
# Example inputs: numpy arrays in the State's dtype policy, from a seed.
# ---------------------------------------------------------------------------


def example_mencius_vote_args(rng, L, W, A, t=40, case="random"):
    """Inputs of the plane at ``(L, W, A)``: Phase2a arrivals now, earlier,
    later or never; Phase2b replies pending, landed or never; some votes
    already cast and some replies dropped. ``case="all_now"`` makes every
    Phase2a arrive at ``t``; ``case="all_inf"`` leaves every message
    unsent (INF). Returns the wrapper's positional arguments (``t``
    last)."""
    shape = (L, W, A)
    i32 = np.int32
    if case == "all_inf":
        inf = np.full(shape, INF, i32)
        return (
            inf, np.zeros(shape, bool), inf.copy(),
            rng.integers(1, 4, shape).astype(i32), np.ones(shape, bool), t,
        )
    kind = rng.integers(0, 4, shape)  # 0 now, 1 earlier, 2 later, 3 never
    p2a = np.where(
        kind == 0, t,
        np.where(kind == 1, t - rng.integers(1, 5, shape),
                 np.where(kind == 2, t + rng.integers(1, 5, shape), INF)),
    )
    if case == "all_now":
        p2a = np.full(shape, t)
    p2b = np.where(
        rng.random(shape) < 0.5, t + rng.integers(-3, 4, shape), INF
    )
    return (
        p2a.astype(i32),
        rng.random(shape) < 0.3,  # voted
        p2b.astype(i32),
        rng.integers(1, 4, shape).astype(i32),  # p2b_lat
        rng.random(shape) < 0.8,  # p2b_delivered
        t,
    )


registry.register(
    registry.Plane(
        name=_PLANE,
        backend="mencius",
        reference=reference_mencius_vote,
        kernel=fused_mencius_vote,
        source=_SOURCE,
        replaces="frankenpaxos_tpu/ops/mencius.py:81 fused_mencius_vote "
        "(pallas_call :124)",
    )
)
