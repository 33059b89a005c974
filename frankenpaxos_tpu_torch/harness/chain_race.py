"""Race the redesigned routes of the CRAQ chain kernel (#11,
``csrc/craq.cu``), the Horizontal vote kernel (#9,
``csrc/horizontal.cu``), the Mencius vote kernel (#7, ``csrc/mencius.cu``)
and the Fast MultiPaxos vote kernel (#8, ``csrc/fastmultipaxos.cu``) on
the card against the kernels they were first written as:

    python -m frankenpaxos_tpu_torch.harness.chain_race [--reps 5] [--parent DIR]
        [--planes craq hz men fmp]

The cases: each plane at its main shape and at ten times it, on inputs
drawn from seed 7 as ``chip_smoke.py``'s kernel rows draw them (the chain
plane at (N, W, L, KV) = (2500, 16, 4, 64) and (25000, 16, 4, 64), the
horizontal vote plane at (P, G, W) = (6, 3334, 32) and (6, 33334, 32)
without a delivery plane, the Mencius plane at (L, W, A) = (3334, 32, 3)
and (33334, 32, 3), the FMP plane at (A, G, W) = (3, 3334, 32) and (3,
33334, 32)), and on the arguments it is given at tick 100 of
``chip_smoke.py``'s CRAQ, Horizontal, Mencius and Fast MultiPaxos runs
(the same configs and seed, run here for 100 ticks on the card, the
plane's call of the next tick caught).

The contenders of each case, all writing the same output tensors:

* ``kernel``: the committed kernel on the route its wrapper picks (the
  vector route in every case; for #8 the scalar route);
* ``restrict``: the committed general route on the same pointers: the
  kernel as first written, its pointers ``__restrict__``, so that the
  compiler may move a load above an earlier store;
* ``parent`` (with ``--parent``): the same source file of another
  checkout (``DIR`` is its root), built the same way, its kernel called
  with the general route's integers (the first ones of the list, which
  that source reads);
* other launch shapes of the committed vector route: the chain kernel
  with 1 chain a CTA of 32 threads (``c1t32``, two 16-byte vectors of
  each row a thread), 4 chains a CTA of 64 (``c4t64``) and of 128
  (``c4t128``) and 8 of 128 (``c8t128``); the horizontal and FMP vote
  kernels with 64 and 256 threads a CTA (``t64``, ``t256``; the Mencius
  vector route's CTA is 32 * A threads).

The races that chose the committed routes also held variants whose code
is gone (the horizontal vote kernel with one thread for both banks, every
latency and proposal tick read with the rest, 2 or 8 slots a thread, an
early return before the loads; the Mencius kernel with a thread a slot
quad; the FMP kernel with 2 or 4 slots a thread and with the classic
Phase2a rows read in the second trip); ``PERF.md`` keeps their times.

Every contender's outputs are first checked bit for bit against the plain
version (each output filled with a sentinel before its launch). Then each
is timed ``reps`` times in turns (the order reversed every other rep):
``harness/microbench.py`` ``device_times`` (cold after a flush that
leaves the L2 dirty, cold after one that leaves it clean, warm), and once
in a steady stream (``steady_ms``, over copies of the inputs four times
the L2). One JSON line a case: the card, each contender's times and
medians, the least time for the bytes the inputs need (the bound), and a
torch copy of those bytes and of every input and output byte timed the
same ways; for #7 and #8 also the bytes their routes move
(``route_bytes``, more than the function needs) and a copy of them.

Needs the card; it writes nothing but the builds.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import statistics
import sys
from typing import Callable, Dict

import numpy as np
import torch

from frankenpaxos_tpu_torch import prng
from frankenpaxos_tpu_torch.harness.microbench import (
    L2_FLUSH_BYTES, device_times, steady_ms,
)
from frankenpaxos_tpu_torch.harness.vector_race import (
    HBM_BYTES_PER_S, card_line, check, compile_sources, copy_times, nbytes,
    parent_source,
)
from frankenpaxos_tpu_torch.ops import _build, registry
from frankenpaxos_tpu_torch.ops import craq as cro
from frankenpaxos_tpu_torch.ops import fastmultipaxos as fmo
from frankenpaxos_tpu_torch.ops import horizontal as hzo
from frankenpaxos_tpu_torch.ops import mencius as meo

SHAPES = {
    "craq": {"craq_main": (2500, 16, 4, 64), "craq_10x": (25000, 16, 4, 64)},
    "hz": {"hz_main": (6, 3334, 32), "hz_10x": (6, 33334, 32)},
    "men": {"men_main": (3334, 32, 3), "men_10x": (33334, 32, 3)},
    "fmp": {"fmp_main": (3, 3334, 32), "fmp_10x": (3, 33334, 32)},
}
TICK = 100
GENERAL = registry.ROUTES.index("general")
# plane: (ops module, plain version, needed bytes, library entry prefix,
# source file).
PLANES = {
    "craq": (cro, cro.reference_craq_chain, cro.craq_chain_needed_bytes,
             "fpx_craq", "craq.cu"),
    "hz": (hzo, hzo.reference_horizontal_vote,
           hzo.horizontal_vote_needed_bytes, "fpx_horizontal", "horizontal.cu"),
    "men": (meo, meo.reference_mencius_vote, meo.mencius_vote_needed_bytes,
            "fpx_mencius", "mencius.cu"),
    "fmp": (fmo, fmo.reference_fmp_vote, fmo.fmp_vote_needed_bytes,
            "fpx_fmp", "fastmultipaxos.cu"),
}
# The bytes the routes of #7 and #8 move, where they read more than the
# function needs.
ROUTE_BYTES = {"men": meo.mencius_vote_route_bytes,
               "fmp": fmo.fmp_vote_route_bytes}
# The launch integers of each plane's threads a CTA and route code.
THREADS_ROUTE = {"craq": (8, 9), "hz": (5, 6), "men": (4, 5), "fmp": (7, 8)}


def build_parent(parent: str, planes) -> Dict[str, ctypes.CDLL]:
    """The source files of ``planes`` in the checkout at ``parent``, built
    as the race's ``parent`` contenders: ``{plane: library}``."""
    libs = compile_sources(
        {plane: parent_source(parent, PLANES[plane][4]) for plane in planes},
        "chain_race", ("craq_chain", "horizontal_vote", "mencius_vote",
                       "fmp_vote"))
    for plane, lib in libs.items():
        getattr(lib, f"{PLANES[plane][3]}_launch").restype = ctypes.c_int
    return libs


def _set(at: Dict[int, int]) -> Callable[[list], list]:
    """An edit of a launch's integers: ``{index: value}``."""
    def edit(ints: list) -> list:
        ints = list(ints)
        for i, v in at.items():
            ints[i] = v
        return ints

    return edit


def general_edit(plane: str) -> Callable[[list], list]:
    """The integer edit that sends a launch to the general route, at the
    256 threads a CTA its wrapper gives it."""
    threads, route = THREADS_ROUTE[plane]
    return _set({threads: 256, route: GENERAL})


def contenders(plane: str, parents) -> Dict[str, tuple]:
    """``{name: (library or None for the committed one, integer edit)}``:
    how each contender runs on a launch's packed pointers and integers
    (the chain kernel's are {N, W, L*KV, KV, tail, t, sides, heal,
    threads, route, chains a CTA}, the horizontal vote kernel's {n, G, W,
    t, quorum, threads, route}, the Mencius kernel's {L, W, A, t, threads,
    route}, the FMP kernel's {A, G, W, t, fq, f, recovery_timeout,
    threads, route})."""
    same, general = _set({}), general_edit(plane)
    threads = THREADS_ROUTE[plane][0]
    if plane == "craq":
        out = {
            "kernel": (None, same), "restrict": (None, general),
            "c1t32": (None, _set({8: 32, 10: 1})),
            "c4t64": (None, _set({8: 64, 10: 4})),
            "c4t128": (None, _set({8: 128, 10: 4})),
            "c8t128": (None, _set({8: 128, 10: 8})),
        }
    elif plane == "men":  # its vector route runs 32 * A threads a CTA
        out = {"kernel": (None, same), "restrict": (None, general)}
    else:
        out = {"kernel": (None, same), "restrict": (None, general),
               "t64": (None, _set({threads: 64})),
               "t256": (None, _set({threads: 256}))}
    if plane in parents:
        out["parent"] = (parents[plane], general)
    return out


def launcher(plane: str, lib, edit, packed) -> Callable[[], None]:
    """One contender's launch on ``packed`` = (pointers, integers)."""
    mod, _, _, prefix, _ = PLANES[plane]
    lib = lib or _build.kernel_lib(prefix, len(mod._PTR_SLOTS))
    fn = getattr(lib, f"{prefix}_launch")
    ptrs, ints = packed
    new = edit(list(ints))
    cints = (ctypes.c_int * len(new))(*new)
    stream = torch.cuda.current_stream().cuda_stream

    def launch() -> None:
        err = fn(ptrs, cints, ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(f"chain_race: {prefix}_launch failed (cuda error {err})")

    return launch


def _statics_of(plane: str, shape) -> dict:
    if plane == "craq":
        N, W, L, KV = shape
        return dict(tail=L - 1, num_keys=KV)
    if plane == "hz":
        n = shape[0] // 2
        return dict(n=n, quorum=(n - 1) // 2 + 1)
    if plane == "fmp":
        f = (shape[0] - 1) // 2
        return dict(fq=f + (f + 1) // 2 + 1, f=f, recovery_timeout=10)
    return {}


def drawn_case(plane: str, shape) -> tuple:
    """``(args, statics)`` of a plane at ``shape`` from seed 7, as
    ``chip_smoke.py``'s kernel rows draw them (no partition; the vote
    plane without a delivery plane, as the healthy tick passes)."""
    rng = np.random.default_rng(7)
    if plane == "hz":
        args = list(registry.to_torch(
            hzo.example_horizontal_vote_args(rng, *shape), "cuda"))
        args[8] = None
        args = tuple(args)
    else:
        make = {"craq": cro.example_craq_chain_args,
                "men": meo.example_mencius_vote_args,
                "fmp": fmo.example_fmp_vote_args}[plane]
        args = registry.to_torch(make(rng, *shape), "cuda")
    return args, _statics_of(plane, shape)


def tick_config(plane: str):
    """``(backend module, config, plane name)`` of ``chip_smoke.py``'s
    main run of the plane."""
    if plane == "craq":
        from frankenpaxos_tpu_torch.tpu import craq_batched as mod

        return mod, mod.BatchedCraqConfig(
            num_chains=2500, chain_len=4, num_keys=64, window=16,
            writes_per_tick=2, reads_per_tick=4, read_window=32, lat_min=1,
            lat_max=3,
        ), "craq_chain"
    if plane == "hz":
        from frankenpaxos_tpu_torch.tpu import horizontal_batched as mod

        return mod, mod.BatchedHorizontalConfig(
            f=1, num_groups=3334, window=32, slots_per_tick=2, alpha=16,
            lat_min=1, lat_max=3, reconfigure_every=50,
        ), "horizontal_vote"
    if plane == "men":
        from frankenpaxos_tpu_torch.tpu import mencius_batched as mod

        return mod, mod.BatchedMenciusConfig(
            f=1, num_leaders=3334, window=32, slots_per_tick=4,
            skip_threshold=16, lat_min=1, lat_max=3, retry_timeout=16,
            num_idle_leaders=834,
        ), "mencius_vote"
    from frankenpaxos_tpu_torch.tpu import fastmultipaxos_batched as mod

    return mod, mod.BatchedFastMultiPaxosConfig(
        f=1, num_groups=3334, window=32, cmd_window=32, cmds_per_tick=2,
        lat_min=1, lat_max=3, jitter=2, recovery_timeout=10, retry_timeout=12,
    ), "fastmultipaxos_vote"


def tick_case(plane: str) -> tuple:
    """``(args, statics)`` the plane is called with at tick :data:`TICK`
    of ``chip_smoke.py``'s run of its backend (CRAQ at 2,500 chains,
    Horizontal at 3334 groups, churning, Mencius and Fast MultiPaxos at
    10,002 acceptors): seed 0, the first :data:`TICK` ticks as its warm-up
    segment, the plane's call in the first tick of the next."""
    mod, cfg, name = tick_config(plane)
    key = prng.PRNGKey(0)
    state, t = mod.run_ticks(cfg, mod.init_state(cfg, device="cuda"), 0, TICK,
                             prng.fold_in(key, 0))
    caught = {}
    plane_obj = registry.PLANES[name]

    def catch(*args, block=0, **statics):
        caught.update(args=args, statics=statics)
        return plane_obj.kernel(*args, block=block, **statics)

    registry.PLANES[name] = dataclasses.replace(plane_obj, kernel=catch)
    try:
        mod.run_ticks(cfg, state, t, 1, prng.fold_in(key, 1))
    finally:
        registry.PLANES[name] = plane_obj
    if caught["args"][-1] != TICK:
        raise AssertionError(f"chain_race: caught tick {caught['args'][-1]}")
    return caught["args"], caught["statics"]


def steady_copies(plane: str, args, statics) -> list:
    """Copies of a case that together hold four times the L2, each as
    ``(packed launch arguments, its inputs, its outputs)`` (the buffers
    live as long as the list)."""
    mod = PLANES[plane][0]
    copies, held = [], 0
    while held < 2 * L2_FLUSH_BYTES or len(copies) < 2:
        copy = tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in args)
        launch, outs = mod.prepared_launch(*copy, **statics)
        copies.append((launch.packed, copy, outs))
        held += nbytes(copy) + nbytes(outs)
    return copies


def kernel_steady_ms(plane: str, args, statics) -> float:
    """``steady_ms`` of the committed kernel, on its wrapper's route, over
    :func:`steady_copies` of a case."""
    return steady_ms([launcher(plane, None, _set({}), c[0])
                      for c in steady_copies(plane, args, statics)])


def race_case(plane: str, case: str, args, statics, parents, reps: int) -> dict:
    """Check every contender on one case, then time them; one dict."""
    mod, plain, needed_bytes, _, _ = PLANES[plane]
    launch, outs = mod.prepared_launch(*args, **statics)
    want = plain(*args, **statics)
    needed = needed_bytes(args, **statics)
    every = nbytes(args) + nbytes(outs)
    kinds = contenders(plane, parents)
    runs = {name: launcher(plane, lib, edit, launch.packed)
            for name, (lib, edit) in kinds.items()}
    for name, run in runs.items():
        check(case, name, run, outs, want)
    times = {name: {} for name in runs}
    order = list(runs)
    for k in range(reps):
        for name in order if k % 2 == 0 else order[::-1]:
            for key, ms in device_times(runs[name]).items():
                times[name].setdefault(key, []).append(ms)
    copies = steady_copies(plane, args, statics)
    steady = {
        name: steady_ms([launcher(plane, lib, edit, c[0]) for c in copies])
        for name, (lib, edit) in kinds.items()
    }
    route = {}
    if plane in ROUTE_BYTES:
        moved = ROUTE_BYTES[plane](args, **statics)
        route = {"route_bytes": moved, "copy_route_ms": copy_times(moved)}
    return {
        "case": case, "plane": plane, "route": launch.route,
        "shape": [int(d) for d in (args[3] if plane == "hz" else args[0]).shape],
        "t": int(args[-1]),
        "bound_ms": needed / HBM_BYTES_PER_S * 1e3, "bound_bytes": needed,
        "all_bytes": every, "exact": True,
        # The yardsticks: a torch copy that reads and writes the bytes the
        # inputs need, and every input and output byte, timed the same ways.
        "copy_needed_ms": copy_times(needed), "copy_all_ms": copy_times(every),
        **route,
        "steady_ms": steady,
        "median_ms": {name: {k: statistics.median(v) for k, v in t.items()}
                      for name, t in times.items()},
        "ms": times,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parent", default="", help="root of another checkout")
    ap.add_argument("--planes", nargs="+", choices=list(PLANES),
                    default=list(PLANES))
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chain_race: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    parents = build_parent(opts.parent, opts.planes) if opts.parent else {}
    cases = []
    for plane in opts.planes:
        for case, shape in SHAPES[plane].items():
            cases.append((plane, case, *drawn_case(plane, shape)))
        cases.append((plane, f"{plane}_tick", *tick_case(plane)))
    for plane, case, args, statics in cases:
        row = race_case(plane, case, args, statics, parents, opts.reps)
        print(json.dumps({**row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
