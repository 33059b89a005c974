"""Race the vector routes of the phase-1 kernel (#4, ``csrc/multipaxos.cu``)
and the grid-vote kernel (#5, ``csrc/compartmentalized.cu``) on the card,
and measure what their cold device times are made of:

    python -m frankenpaxos_tpu_torch.harness.vector_race [--reps 5] [--parent DIR]

The contenders of each main-path case:

* ``kernel``: the committed kernel, through its wrapper's
  ``prepared_launch``;
* the variants of ``VARIANTS``: text edits of the committed source, each
  built with ``nvcc`` into ``<build dir>/vector_race/`` and called with
  the wrapper's pointers and integers. An edit swaps its two texts,
  whichever of them the committed source holds: the ``lb_flip`` ones
  give the vector kernel the other of 2 or 3 CTAs an SM as the minimum
  of its launch bounds (at most 128 or 80 registers a thread),
  ``mp_batch4`` takes the acceptor rows four at a time instead of three.
  Each variant's registers and spills print first, one JSON line each;
* ``parent`` (with ``--parent``): the same source file of another
  checkout (``DIR`` is its root), built the same way and called with the
  same pointers; the phase-1 kernel there picks its own route, the grid
  vote gets the scalar route's groups per CTA.

The cases are the main-path shapes of ``chip_smoke.py``: the phase-1
plane at (A, G, W) = (3, 3334, 256) on the "random" and the failover-like
"sparse" inputs, the grid vote at (R, C, NR, G, W) = (2, 2, 3, 25000,
32), all drawn from seed 7. Every contender's outputs are first checked
bit for bit against the plain version (each output filled with a
sentinel before its launch). Then each is timed ``reps`` times in turns
(parent, kernel, variant, then the reverse order): ``device_times`` of
``harness/microbench.py``, cold after a flush that leaves the L2 dirty,
cold after one that leaves it clean, and warm. The kernel is also timed
in a steady stream (``steady_ms``: launches round-robin over copies of
the inputs four times the L2's size, so each reads from device memory
and its outputs are written back during the next). One JSON line a case:
the card, each contender's times (ms a launch) and medians, the least
time for the bytes these inputs need, and a torch copy of those bytes
timed the same four ways (the yardstick); for the grid vote also the
bytes of the whole 32-byte sectors they touch.

Then two more measurements, a JSON line each:

* ``copy_curve``: a torch copy at several sizes (16 MB to 2 GB moved),
  timed the same four ways: how far the cold times of a copy of a
  kernel's size are from the card's copy rate, and why;
* ``route_race``: at the shapes that take the grid vote's scalar route
  (the main shape on misaligned copies, W = 12, grids of six and nine
  cells), the scalar route against the general kernel on the same
  pointers, both checked bit for bit first.

Needs the card; it writes nothing but the builds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from typing import Callable, Dict

import numpy as np
import torch

from frankenpaxos_tpu_torch.harness.microbench import (
    L2_FLUSH_BYTES, device_times, steady_ms,
)
from frankenpaxos_tpu_torch.ops import _build, registry
from frankenpaxos_tpu_torch.ops import compartmentalized as czo
from frankenpaxos_tpu_torch.ops import multipaxos as mp

HBM_BYTES_PER_S = 3.35e12
FLAGSHIP = (3, 3334, 256)
CZ_MAIN = (2, 2, 3, 25000, 32)
# name: (source file, its edits as (text, the text it swaps with)).
VARIANTS = {
    "cz_lb_flip": ("compartmentalized.cu", (
        ("__launch_bounds__(256, 2) grid_vote_vec", "__launch_bounds__(256, 3) grid_vote_vec"),
    )),
    "mp_lb_flip": ("multipaxos.cu", (
        ("__launch_bounds__(256, 2) p1_promise_vec", "__launch_bounds__(256, 3) p1_promise_vec"),
    )),
    "mp_batch4": ("multipaxos.cu", (
        ("constexpr int kP1Batch = 3;", "constexpr int kP1Batch = 4;"),
    )),
}


def variant_source(name: str) -> str:
    """The committed source of a variant with its edits applied."""
    source, edits = VARIANTS[name]
    with open(os.path.join(_build.CSRC_DIR, source)) as f:
        src = f.read()
    for one, other in edits:
        if src.count(one) == 1:
            src = src.replace(one, other)
        elif src.count(other) == 1:
            src = src.replace(other, one)
        else:
            raise RuntimeError(f"{source} no longer holds {one!r} once")
    return src


def _compile(sources: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """Build each ``name: source text`` into its own shared library, one
    ``nvcc`` each, all started together; the headers come from csrc/."""
    out = os.path.join(_build.build_dir(), "vector_race")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = os.path.join(out, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(out, f"{name}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
               "-I", _build.CSRC_DIR, "-o", so, src]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        libs[name] = ctypes.CDLL(so)
        print(json.dumps({"variant": name, "ptxas": vector_kernel_report(log)}),
              flush=True)
    return libs


def vector_kernel_report(log: str) -> list:
    """The compiler's registers and spills of the vector kernels."""
    lines = log.splitlines()
    return [
        " ".join(x.strip() for x in lines[i:i + 4])
        for i, line in enumerate(lines)
        if "Compiling entry function" in line
        and ("p1_promise_vec" in line or "grid_vote_vec" in line)
    ]


def build(parent: str = "") -> Dict[str, ctypes.CDLL]:
    """Every variant of ``VARIANTS``, and with ``parent`` that checkout's
    two source files. Keys: ``mp_<contender>`` and ``cz_<contender>``."""
    sources = {name: variant_source(name) for name in VARIANTS}
    if parent:
        csrc = os.path.join(parent, "frankenpaxos_tpu_torch", "csrc")
        for key, name in (("mp_parent", "multipaxos.cu"),
                          ("cz_parent", "compartmentalized.cu")):
            with open(os.path.join(csrc, name)) as f:
                # The parent's own common.cuh sits beside its sources.
                sources[key] = f.read().replace(
                    '#include "common.cuh"',
                    f'#include "{os.path.abspath(os.path.join(csrc, "common.cuh"))}"')
    libs = _compile(sources)
    for lib in libs.values():
        for fn in ("fpx_mp_launch", "fpx_cz_launch"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = ctypes.c_int
    return libs


def _via(lib, fn: str, packed, stream) -> Callable[[], None]:
    def launch() -> None:
        err = getattr(lib, fn)(*packed, ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(f"vector_race: {fn} failed (cuda error {err})")

    return launch


def contenders(case: str, libs, args):
    """``(launches by contender, outputs, plain outputs, needed bytes)``
    for one case; every launch writes the same output tensors."""
    stream = torch.cuda.current_stream().cuda_stream
    if case.startswith("p1"):
        launch, outs = mp.prepared_launch("multipaxos_p1_promise", *args)
        want = mp.reference_p1_promise(*args)
        needed = mp.p1_promise_needed_bytes(args)
        which, A, ptrs, ints = launch.packed
        packed = (ctypes.c_int(which), ctypes.c_int(A), ptrs, ints)
        out = {"kernel": launch}
        for key, lib in libs.items():
            if key.startswith("mp_"):
                out[key[3:]] = _via(lib, "fpx_mp_launch", packed, stream)
        return out, outs, want, needed
    st = dict(retry_timeout=16)
    launch, outs = czo.prepared_launch(*args, **st)
    want = czo.reference_grid_vote(*args, **st)
    needed = czo.grid_vote_needed_bytes(args, want)
    print(json.dumps({"case": case, "sector_bytes": grid_vote_sector_bytes(args, want),
                      "bound_bytes": needed}), flush=True)
    ptrs, ints = launch.packed
    out = {"kernel": launch}
    for key, lib in libs.items():
        if key.startswith("cz_") and key != "cz_parent":
            out[key[3:]] = _via(lib, "fpx_cz_launch", (ptrs, ints), stream)
    if "cz_parent" in libs:
        W = args[0].shape[3]
        scalar = list(ints)
        scalar[7] = czo._groups_per_cta("scalar", W, 0)
        scalar[8] = 0
        packed = (ptrs, (ctypes.c_int * len(scalar))(*scalar))
        out["parent"] = _via(libs["cz_parent"], "fpx_cz_launch", packed, stream)
    return out, outs, want, needed


def grid_vote_sector_bytes(args, outs) -> int:
    """The grid vote's traffic in whole 32-byte sectors on these inputs:
    every dense row once, and of each sparse plane the 8-lane rows (a
    sector of an int32 plane, a quarter of one of a byte plane) that hold
    at least one lane the function needs. What any kernel must move when
    it reads a sector for its first needed lane."""
    R, C, G, W = args[0].shape
    NR = args[2].shape[0]

    def rows(mask) -> int:  # 8-lane rows with a needed lane
        return int(mask.reshape(*mask.shape[:-1], W // 8, 8).any(-1).sum())

    aged = torch.where(args[0] == 32767, args[0], torch.clamp(args[0] - 1, min=-1))
    vote = aged == 0
    timed, newly = outs[7], outs[6]
    dense = sum(x.numel() * x.element_size() for x in args[:9]) + sum(
        x.numel() * x.element_size() for x in outs)
    return (dense + rows(vote) * 8 + rows(vote & args[9]) * 32
            + rows(timed) * R * C * 8 + rows(timed[None, None] & args[10]) * 32
            + rows(newly) * NR * 32)


def copies_for(footprint: int) -> int:
    """Copies of a working set of ``footprint`` bytes that together hold
    at least four times the L2 (:data:`L2_FLUSH_BYTES` is twice it)."""
    return max(2, -(-2 * L2_FLUSH_BYTES // footprint))


def nbytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


def kernel_steady_ms(case: str, args) -> float:
    """:func:`steady_ms` of the committed kernel on this case's inputs,
    over copies of its inputs and outputs that hold four times the L2."""
    launches, held = [], 0
    while held < 2 * L2_FLUSH_BYTES:
        copy = tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in args)
        if case.startswith("p1"):
            launch, outs = mp.prepared_launch("multipaxos_p1_promise", *copy)
        else:
            launch, outs = czo.prepared_launch(*copy, retry_timeout=16)
        launches.append(launch)
        held += nbytes(copy) + nbytes(outs)
    return steady_ms(launches)


def copy_times(total: int) -> Dict[str, float]:
    """A torch ``copy_`` that reads and writes ``total`` bytes in all:
    ``device_times`` and ``steady_ms`` (over enough pairs of buffers)."""
    half = total // 2
    pairs = [
        (torch.empty(half, dtype=torch.uint8, device="cuda"),
         torch.empty(half, dtype=torch.uint8, device="cuda"))
        for _ in range(copies_for(total))
    ]
    launches = [lambda d=d, s=s: d.copy_(s) for s, d in pairs]
    return {**device_times(launches[0]), "steady_ms": steady_ms(launches)}


def copy_curve() -> list:
    """:func:`copy_times` at 16 MB to 2 GB moved, with each time's rate
    in GB/s."""
    out = []
    for mb in (16, 34, 58, 128, 512, 2048):
        total = mb * 2**20
        times = copy_times(total)
        out.append({"mb_moved": mb, "ms": times,
                    "gb_per_s": {k: total / v / 1e6 for k, v in times.items()}})
    return out


# (shape, misaligned): the grid vote's scalar-route inputs, each also sent
# to the general kernel. The main shape misaligned; W = 12 at the main
# shape's slot count; six and nine grid cells (a 3 x 3 grid tolerates
# f = 2).
ROUTE_RACE = (
    (CZ_MAIN, True),
    ((2, 2, 3, 25000 * 32 // 12, 12), False),
    ((2, 3, 3, 25000, 32), False),
    ((3, 3, 3, 25000, 32), False),
)


def route_race(reps: int) -> list:
    """The grid vote's scalar route against its general kernel on each
    case of :data:`ROUTE_RACE`: the same pointers, the route code and groups per
    CTA changed. Both checked bit for bit, then ``device_times`` in turns;
    one dict a case."""
    stream = torch.cuda.current_stream().cuda_stream
    general = registry.ROUTES.index("general")
    lib = _build.kernel_lib("fpx_cz", len(czo._PTR_SLOTS))
    out = []
    for shape, skew in ROUTE_RACE:
        rng = np.random.default_rng(7)
        args = registry.to_torch(czo.example_grid_vote_args(rng, *shape), "cuda")
        args = registry.misaligned(args) if skew else args
        launch, outs = czo.prepared_launch(*args, retry_timeout=16)
        want = czo.reference_grid_vote(*args, retry_timeout=16)
        ptrs, ints = launch.packed
        gen = list(ints)
        gen[7], gen[8] = 1, general
        gen = (ctypes.c_int * len(gen))(*gen)
        other = _via(lib, "fpx_cz_launch", (ptrs, gen), stream)
        if launch.route != "scalar":
            raise AssertionError(f"route_race: {shape} takes {launch.route}")
        runs = {"scalar": launch, "general": other}
        for name, run in runs.items():
            check(f"route_race {shape}", name, run, outs, want)
        times = {name: {} for name in runs}
        for k in range(reps):
            for name in runs if k % 2 == 0 else list(runs)[::-1]:
                for key, ms in device_times(runs[name]).items():
                    times[name].setdefault(key, []).append(ms)
        out.append({
            "shape": shape, "misaligned": skew,
            "median_ms": {n: {k: statistics.median(v) for k, v in t.items()}
                          for n, t in times.items()},
            "ms": times,
        })
    return out


def check(case: str, name: str, launch, outs, want) -> None:
    """Run ``launch`` into ``outs`` filled with a sentinel; raise unless
    every output equals the plain version's."""
    for o in outs:
        o.fill_(-3 if o.dtype != torch.bool else 1)
    launch()
    torch.cuda.synchronize()
    for i, (w, g) in enumerate(zip(want, outs)):
        if w.dtype != g.dtype or not torch.equal(w, g):
            raise AssertionError(f"vector_race: {case}: {name} output {i} differs")


def cases() -> dict:
    out = {}
    for case in ("random", "sparse"):
        rng = np.random.default_rng(7)
        out[f"p1_{case}"] = mp.to_torch(
            mp.example_p1_promise_args(rng, *FLAGSHIP, case=case), "cuda")
    out["grid_vote"] = registry.to_torch(
        czo.example_grid_vote_args(np.random.default_rng(7), *CZ_MAIN), "cuda")
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parent", default="", help="root of another checkout")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("vector_race: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    libs = build(opts.parent)
    for case, args in cases().items():
        launches, outs, want, needed = contenders(case, libs, args)
        for name, launch in launches.items():
            check(case, name, launch, outs, want)
        times = {name: {} for name in launches}
        order = list(launches)
        for k in range(opts.reps):
            for name in order if k % 2 == 0 else order[::-1]:
                for key, ms in device_times(launches[name]).items():
                    times[name].setdefault(key, []).append(ms)
        print(json.dumps({
            "case": case, "card": card, "bound_ms": needed / HBM_BYTES_PER_S * 1e3,
            "bound_bytes": needed, "exact": True,
            # The yardstick: a torch copy that reads and writes the bytes
            # these inputs need, timed the same ways.
            "copy_yardstick_ms": copy_times(needed),
            "kernel_steady_ms": kernel_steady_ms(case, args),
            "ms": times,
            "median_ms": {
                name: {k: statistics.median(v) for k, v in t.items()}
                for name, t in times.items()
            },
        }), flush=True)
    print(json.dumps({"copy_curve": copy_curve(), "card": card}), flush=True)
    for row in route_race(opts.reps):
        print(json.dumps({"route_race": row, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
