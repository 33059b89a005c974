"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package. Phases:

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``frankenpaxos_tpu_torch/csrc`` (set-up);
3. hold each kernel against its plain PyTorch version on the card, with
   a tolerance of zero (every output equal, dtypes included): the four
   MultiPaxos kernels at the flagship shape (3, 3334, 256), a ragged
   shape (3, 7, 16) and f=2 (5, 64, 64), the whole-tick kernel with
   aging on and off, the phase-1 kernel also on two edge inputs (every
   slot a noop; vote-round ties with different values) and on each of
   its two routes (``P1_ROUTE_CASES``: the vector route at the flagship
   on the random, failover-like "sparse", noop and tie inputs and at
   A = 5, A = 11 and W = 2048; the general kernel on misaligned copies,
   A = 11 and W = 2048 among them, and at W = 12), each case on the
   route it names (counted by the wrapper); the
   Compartmentalized grid-vote kernel at (R, C, NR, G, W) =
   (2, 2, 3, 25000, 32), the ragged (2, 3, 2, 7, 16) and (3, 2, 3, 64, 64),
   and on each of its routes (``CZ_ROUTE_CASES``: vector at W = 8, 16,
   24, 32, 64, 256 and 1024 with up to four grid cells and replicas,
   scalar on a misaligned copy, at W = 12 and with six grid cells or five
   replicas, general at W = 1030 and 2048);
   the Mencius vote kernel on each of its routes (``MEN_ROUTE_CASES``:
   vector at (L, W, A) = (3334, 32, 3), (33334, 32, 3), (7, 16, 3),
   (64, 32, 5), (4, 8, 7), (8, 4, 9) and (4, 6, 3), general at A = 11 and
   L * W % 4 != 0 and on a misaligned copy of every case) on random,
   all-arrive-now and all-INF inputs; the Fast MultiPaxos vote kernel on
   each of its routes (``FMP_ROUTE_CASES``: scalar at (A, G, W) = (3,
   3334, 32), (3, 33334, 32), (3, 7, 16), (5, 64, 32), (7, 16, 16), (9,
   16, 16), W = 6 and an odd G * W, aligned and misaligned, and on a
   block of part warps; general at A = 11 and 13) on random inputs and six
   edge inputs (no visible vote, an all-distinct census, ties, a slot at
   the recovery timeout, a contradicted fast-committed value, classic
   latencies of 0);
4. the MultiPaxos main path at the flagship: f=1, 3334 groups (10,002
   acceptors), W=256, K=32, latency 1-3, no drops, thrifty, retry 16,
   driven through ``TpuSimTransport`` for 100 warm-up and 300 timed
   ticks; invariants, progress, and one whole-tick launch per tick;
5. the 100k-acceptor point (33,334 groups), 50 ticks;
6. the per-plane route with drops (``disable=("multipaxos_fused_tick",)``,
   drop 0.05), 100 ticks: one vote and one dispatch launch per tick;
7. MultiPaxos card against CPU: the small test config (G=4, W=16), seed
   0, 120 ticks, every State leaf equal;
8. the Compartmentalized main path: 25,000 groups of a 2x2 grid (100,000
   acceptors), P=8, B=2, U=2, NR=3, W=32, batch 8, 4 arrivals per
   batcher per tick, latency 1-3, retry 16, no faults, reads off,
   through ``compartmentalized_batched.init_state`` / ``run_ticks`` for
   100 warm-up and 300 timed ticks; invariants, progress, and one
   grid-vote launch per tick, every one on the vector route;
9. the same shape with reads (rate 2, window 6) and faults (drop 0.05,
   jitter 1, crash 0.02, revive 0.2), 100 ticks: retries, drops and
   served reads;
10. Compartmentalized card against CPU: ``analysis_config`` with drops,
    jitter, proxy crashes and a healing grid-cell partition, seed 0, 120
    ticks, every State leaf equal;
11. MultiPaxos under failure at the flagship shape: leader crashes
    (fail 0.005, revive 0.2, heartbeat timeout 5) with device elections
    and a Matchmaker reconfiguration every 100 ticks, through
    ``TpuSimTransport`` for 100 warm-up and 300 timed ticks: invariants,
    progress, elections, reconfigurations and GC'd configurations, one
    whole-tick and two phase-1 launches per tick, every phase-1 launch on
    the vector route; the profile logs the phase-1 kernel's device time a
    launch (the Compartmentalized profile the grid vote's); then one host
    ``leader_change()`` and one ``reconfigure()`` and 20 more ticks;
12. the flagship shape under a static fault plan (drop 0.05, jitter 1,
    crash 0.01 / revive 0.2, acceptor 2 cut from tick 20 to 60), 100
    ticks: drops, retries, elections, progress after the heal;
13. BASELINE config 4 as the JAX package defines it
    (``baseline_configs.py`` ``config4_matchmaker_churn``, full size):
    G=256, W=64, K=4, seed 3, 100 warm-up ticks then 20 segments of 25,
    churn-free against a reconfiguration every 100 ticks;
14. MultiPaxos failure path card against CPU: G=4, W=16 with crashes,
    elections, reconfiguration every 15 ticks and a fault plan with
    drop, dup, jitter, crash and a healing partition; 60 ticks,
    ``leader_change()``, 30 ticks, ``reconfigure()``, 30 ticks; every
    State leaf equal;
15. Mencius at 10,002 acceptors: f=1, 3334 leaders (834 of them
    unloaded, so skips always run), W=32, K=4, skip threshold 16, latency
    1-3, retry 16, through ``mencius_batched.init_state`` / ``run_ticks``
    for 100 warm-up and 300 timed ticks: invariants, the global log, real
    commands and skips advance, one vote launch per tick, every one on
    the vector route (as in phases 16-17);
16. Mencius at 100,002 acceptors (33,334 leaders, 8,334 unloaded), 50
    ticks;
17. Mencius under a static plan (Phase2a drop 0.05, and drop 0.05,
    jitter 1, crash 0.01 / revive 0.2, acceptor 2 cut from tick 20 to
    60), 100 ticks: drops, retries, progress after the heal;
18. Fast MultiPaxos at 10,002 acceptors: f=1, 3334 groups, W=32, CW=32,
    K=2, latency 1-3, jitter 2, recovery timeout 10, retry 12, through
    ``fastmultipaxos_batched.init_state`` / ``run_ticks`` for 100 warm-up
    and 300 timed ticks: invariants, no safety violation, commands done,
    recoveries, one vote launch per tick, every one on the scalar route
    (as in phases 19-20);
19. Fast MultiPaxos at 100,002 acceptors (33,334 groups), 50 ticks;
20. Fast MultiPaxos under the same static plan (proposer crashes), 100
    ticks: revivals as leader changes, progress after the heal;
21-22. Mencius and Fast MultiPaxos card against CPU: ``analysis_config``
    with drop, dup, jitter, crash and a healing cut (Mencius also idle
    leaders and Phase2a drops), seed 0, 120 ticks, every State leaf equal;
23. timing: each kernel and its plain version at its main shape beside
    the least time the card could take for the bytes the kernel must
    move (the Mencius and Fast MultiPaxos vote kernels at the 10k and
    100k shapes). ``ms``: CUDA events around one call from Python, median
    of 30 back to back: the host's enqueue plus the kernel, with a warm
    L2. ``device_ms_cold`` / ``device_ms_cold_clean`` /
    ``device_ms_warm``: the kernel alone on the device
    (``harness/microbench.py`` ``device_times``: each launch after a 100
    MB write that flushes the L2 and leaves it dirty, median of 30; the
    same after a 100 MB read that leaves it clean; and 30 back to back,
    all queued behind a spin so the host's enqueue is hidden). The share
    of the bound is read from the first. #4 and #5 add
    ``copy_yardstick_ms`` (and ``_clean``), the cold times of a torch
    ``copy_`` of their bound's bytes, and #4 its cold times and bound on
    the failover-like "sparse" inputs. The bound of #7 and #8 is the bytes
    the function needs (``mencius_vote_needed_bytes``,
    ``fmp_vote_needed_bytes``); ``route_bytes`` and its copy yardstick
    (``_route``) are what their main-path routes move;
24-31. Horizontal MultiPaxos at 3334 groups, its churn timelines, 33,334
    groups and a fault plan; Scalog at 256 and 10,000 shards and under a
    fault plan; both card against CPU; their kernels' rows (#10's with
    its launch floor: the same memset and grid running a kernel that does
    nothing, ``floor_ms_cold`` / ``_clean`` / ``_warm``) and tick splits;
32. the repaired shapes (run in phase 3): the four MultiPaxos kernels at
    A = 11 (f = 5) and W = 2048, the grid vote at W = 2048, the FMP vote
    at A = 11, the horizontal vote at n = 9 and the Scalog cut ring at
    P = 40, bit for bit against their plain versions and timed; f=5
    MultiPaxos and a 40-cut Scalog, 50 ticks, card against CPU;
33-36. CRAQ (chain_len 4, 64 keys, W=16, 2 writes and 4 reads a tick,
    read window 32) at 2,500 chains (10,000 chain nodes; 100 warm-up and
    300 timed ticks, one chain launch a tick, profiled), at 256 chains,
    at 25,000 chains (50 cold ticks), and at 256 chains under drops,
    jitter, middle-node crashes and node 2 cut from tick 20 to 60;
37-40. BPaxos (5 leaders, 5 replicas, window 64: V = 320) at conflict
    1/4 (100 warm-up and 300 timed ticks, one execute launch a tick,
    profiled), at conflict 1 (SCCs form), at window 256 (V = 1280, the
    working set in opted-in shared memory, 50 ticks, then 20 profiled)
    and under drops, jitter and leader lane 2 cut from tick 20 to 60;
41. CRAQ and BPaxos card against CPU, 120 ticks, every State leaf equal;
42. the chain and execute kernels' rows (the execute kernel on the BPaxos
    runs' own inputs, with its shared bytes a CTA, shared or scratch, and
    the word operations and rounds of its schedule on those inputs) and
    the two tick splits;
43. the six-pass grid vote (the race baseline of the fused one) held
    against its plain passes, pass by pass and composed, and its ten
    outputs against the fused kernel's, with a tolerance of zero, at
    (R, C, NR, G, W) = (2, 2, 3, 25000, 32), (2, 3, 2, 7, 16),
    (3, 2, 3, 64, 64) and (2, 2, 3, 512, 2048);
44. its time at the main shape (CUDA events, the profiler's device time,
    six kernel launches a call), its plain passes' time, and its bound:
    the bytes each pass reads and writes, summed;
45. the port's microbench (``harness/microbench.py``) at its default
    sizes: every kernel against its plain version, the whole-tick kernel
    against the planes it replaces, the fused grid vote against its six
    passes, and the execute kernel and its plain version against the host
    pointer walk; its JSON lines are printed, and any kernel or race whose
    outputs differ fails the run. Its run is the six-pass kernel's main
    path: its launch count goes into the kernels line.

The chain kernel (#11), the horizontal vote kernel (#9) and the Mencius
vote kernel (#7) are held against their plain versions on each of their
two routes (``CR_ROUTE_CASES``, ``HZ_ROUTE_CASES``, ``MEN_ROUTE_CASES``):
the vector route at every shape that takes it, the general kernel at the
shapes that do not and on a misaligned copy of every case, each launch
on the route its case names (counted by the wrapper); every main-path
launch of the three kernels must take the vector route. The FMP vote
kernel (#8) is held the same way on its scalar and general routes
(``FMP_ROUTE_CASES``), and every main-path launch of it must take the
scalar route. The four kernels' rows add the general route's cold time
(the kernel as first written, its pointers ``__restrict__``), the
steady-stream time and a torch copy of the needed and of all bytes
(``vector_route_keys``).
The chain and execute kernels are held against their plain versions in
phase 3: the chain kernel at eight shapes on four inputs and three
partitions, the
execute kernel at six windows on five inputs (the largest in shared
memory, V = 1314, and the first on the global scratch, V = 1315, among
them) and on an all-active dense graph at V = 1280, with its own and a
shared adjacency, and against the host oracle at V = 320, 1280, 1314 and
1315 and on the long path and the dense graph at V = 1280.

Every launch count is set to 0 just before a main-path run and read just
after it; launches made to compare or time a kernel are not counted.
Any failure raises, so the exit code is not 0 and no result is printed.
The second-to-last line is the kernels JSON, the last line the result.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth, and
# the int32 issue rate of its CUDA cores (64 int32 lanes per SM per
# clock on 132 SMs at the 1.98 GHz boost clock: about 16.7 Tops/s).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

FLAGSHIP = (3, 3334, 256)
# (R, C, NR, G, W) of the Compartmentalized main path: bench.py's
# multichip shape with its 8-device total of groups on one card.
CZ_MAIN = (2, 2, 3, 25000, 32)


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def outputs_equal(name, plain, kern) -> int:
    """Raise unless every output is equal; returns the largest absolute
    difference (0)."""
    if len(plain) != len(kern):
        raise AssertionError(f"{name}: {len(plain)} vs {len(kern)} outputs")
    worst = 0
    for i, (p, k) in enumerate(zip(plain, kern)):
        if p.dtype != k.dtype or p.shape != k.shape:
            raise AssertionError(
                f"{name} output {i}: {k.dtype}{tuple(k.shape)} vs plain "
                f"{p.dtype}{tuple(p.shape)}"
            )
        diff = int((p.to(torch.int64) - k.to(torch.int64)).abs().max()) if (
            p.numel()
        ) else 0
        worst = max(worst, diff)
        if diff:
            raise AssertionError(f"{name} output {i} differs by {diff}")
    return worst


def plane_args(mp, which, shape, seed, age=True):
    A, G, W = shape
    rng = np.random.default_rng(seed)
    st = dict(f=(A - 1) // 2, retry_timeout=16, num_groups=G)
    if which == "vote":
        return mp.to_torch(mp.example_vote_quorum_args(rng, A, G, W), "cuda"), {}
    if which == "dispatch":
        return mp.to_torch(mp.example_mp_dispatch_args(rng, A, G, W), "cuda"), st
    if which == "p1":
        return mp.to_torch(mp.example_p1_promise_args(rng, A, G, W), "cuda"), {}
    args = mp.example_fused_tick_args(rng, A, G, W, age=age)
    return mp.to_torch(args, "cuda"), dict(st, age=age)


def run_checked(tr, ticks: int):
    t0 = time.perf_counter()
    tr.run(ticks)
    tr.block_until_ready()
    return time.perf_counter() - t0


def assert_invariants(tr, what: str) -> None:
    inv = tr.check_invariants()
    bad = [k for k, v in inv.items() if not v]
    if bad:
        raise AssertionError(f"{what}: invariants failed: {bad}")


def time_ms(fn, reps: int = 30) -> float:
    """Median device time of one call, from CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_times(launch) -> dict:
    """``device_ms_cold``, ``device_ms_cold_clean`` and ``device_ms_warm``
    of one launch (``harness/microbench.py`` ``device_times``: CUDA events
    with the host's enqueue hidden, cold after an L2 flush that leaves
    the cache dirty and after one that leaves it clean, warm back to
    back)."""
    from frankenpaxos_tpu_torch.harness.microbench import device_times as times

    return times(launch)


def copy_yardstick_ms(total_bytes: int) -> tuple:
    """The cold device times, after the dirty and the clean flush, of a
    torch ``copy_`` that reads and writes ``total_bytes`` in all: the
    bandwidth this card attains on a plain copy, beside a kernel's
    bound."""
    src = torch.empty(total_bytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    times = device_times(lambda: dst.copy_(src))
    return times["device_ms_cold"], times["device_ms_cold_clean"]


def yardstick_keys(total_bytes: int, suffix: str = "") -> dict:
    """A kernels-line row's ``copy_yardstick_ms`` and
    ``copy_yardstick_ms_clean`` (with ``suffix``) for ``total_bytes``."""
    dirty, clean = copy_yardstick_ms(total_bytes)
    return {f"copy_yardstick_ms{suffix}": dirty,
            f"copy_yardstick_ms_clean{suffix}": clean}


def profile_ticks(run, sync, ticks: int, card: str, phase: str,
                  kernel: str = "") -> dict:
    """Device time by kernel over ``run(ticks)`` (torch.profiler), and
    the device's busy share of the wall-clock window; with ``kernel``, the
    device time of one launch of the kernels whose name holds it."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(ticks)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3

    from torch.autograd import DeviceType

    def dev_us(evt) -> float:
        return float(getattr(evt, "self_device_time_total", 0.0) or 0.0)

    # Device-side events only (the kernels): the host-side aten ops that
    # launched them report the same device time again.
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and dev_us(e) > 0
    ]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:10]
    out = {
        "phase": phase, "card": card, "ticks": ticks,
        "wall_ms_per_tick": wall_ms / ticks,
        "device_ms_per_tick": busy_ms / ticks,
        "device_busy_share": busy_ms / wall_ms if wall_ms else None,
        "top_device_ms_per_tick": [
            [e.key[:120], dev_us(e) / 1e3 / ticks, e.count // ticks]
            for e in top
        ],
        "device_launches_per_tick": sum(e.count for e in events) / ticks,
    }
    if kernel:
        mine = [e for e in events if kernel in e.key]
        out["kernel_device_ms_per_launch"] = sum(dev_us(e) for e in mine) / 1e3 / (
            max(1, sum(e.count for e in mine))
        )
    return out


def nbytes(tensors) -> int:
    return sum(
        x.numel() * x.element_size()
        for x in tensors
        if isinstance(x, torch.Tensor)
    )


class BatchedSim:
    """A batched backend without a transport class (Compartmentalized
    MultiPaxos, Mencius, Fast MultiPaxos, Horizontal MultiPaxos, Scalog)
    driven through its entry
    points: ``init_state``, then ``run_ticks`` with one key per segment
    (``fold_in`` of the seed's key, as ``TpuSimTransport`` keys its
    segments)."""

    def __init__(self, mod, prng, cfg, seed=0, device=None):
        self.mod, self.prng, self.cfg = mod, prng, cfg
        self.state = mod.init_state(cfg, device=device)
        self.key = prng.PRNGKey(seed)
        self.t = 0
        self.segment = 0

    def run(self, ticks: int) -> None:
        key = self.prng.fold_in(self.key, self.segment)
        self.segment += 1
        self.state, self.t = self.mod.run_ticks(
            self.cfg, self.state, self.t, ticks, key
        )

    def sync(self) -> None:
        if self.state.telemetry.ticks.is_cuda:
            torch.cuda.synchronize()

    def timed_run(self, ticks: int) -> float:
        self.sync()
        t0 = time.perf_counter()
        self.run(ticks)
        self.sync()
        return time.perf_counter() - t0

    def invariants(self) -> dict:
        inv = self.mod.check_invariants(self.cfg, self.state, self.t)
        return {k: bool(v) for k, v in inv.items()}

    def assert_invariants(self, what: str, skip=()) -> None:
        bad = [k for k, v in self.invariants().items() if not v and k not in skip]
        if bad:
            raise AssertionError(f"{what}: invariants failed: {bad}")

    def stats(self) -> dict:
        return self.mod.stats(self.cfg, self.state, self.t)

    def leaves(self) -> dict:
        return self.mod.state_to_numpy(self.state)

    def get(self, *names) -> tuple:
        return tuple(int(getattr(self.state, n)) for n in names)


def hist_percentiles(hist) -> tuple:
    """(p50, p99) in ticks from a latency histogram (the first bin whose
    cumulative count reaches half, or 99%, of the total); -1 if empty."""
    hist = np.asarray(hist.cpu() if isinstance(hist, torch.Tensor) else hist)
    total = int(hist.sum())
    if not total:
        return -1, -1
    cum = hist.cumsum()
    p50 = int((cum >= max(1, (total + 1) // 2)).argmax())
    p99 = int((cum >= max(1, -(-total * 99 // 100))).argmax())
    return p50, p99


def only_launches(registry, plane: str, want: int, what: str) -> dict:
    """The launch counts since the last reset; raise unless ``plane`` ran
    exactly ``want`` times and no other plane ran."""
    launches = dict(registry.LAUNCHES)
    if launches[plane] != want or any(
        n for name, n in launches.items() if name != plane
    ):
        raise AssertionError(f"{what} launches: {launches}")
    return launches


def only_route(registry, plane: str, want: int, what: str,
               route: str = "vector") -> dict:
    """Raise unless every one of the ``want`` launches of ``plane`` in the
    run took ``route``; returns the per-route counts."""
    routes = dict(registry.ROUTE_LAUNCHES.get(plane, {}))
    if routes != {route: want}:
        raise AssertionError(f"{what}: {plane} routes {routes}, want {want} {route}")
    return routes


def one_route(registry, plane: str, route: str, label: str, kern, args,
              statics):
    """``kern(*args, **statics)`` once, synchronised; raise unless it
    launched ``plane``'s kernel once, on ``route``. Returns the outputs."""
    registry.reset_launches()
    got = kern(*args, **statics)
    torch.cuda.synchronize()
    took = registry.ROUTE_LAUNCHES.get(plane, {})
    if took != {route: 1}:
        raise AssertionError(f"{label}: routes {took}, want {route}")
    return got


def cards_equal(mod, prng, cfg, what: str, ticks: int = 120) -> int:
    """Run ``cfg`` from seed 0 on the card and on the CPU; raise unless
    every State leaf is equal (dtypes included). Returns the leaf count."""
    on_card = BatchedSim(mod, prng, cfg, seed=0)
    on_cpu = BatchedSim(mod, prng, cfg, seed=0, device="cpu")
    on_card.run(ticks)
    on_cpu.run(ticks)
    a, b = on_card.leaves(), on_cpu.leaves()
    bad = [k for k in a if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
    if bad or on_card.invariants() != on_cpu.invariants():
        raise AssertionError(f"{what} card vs CPU: leaves differ: {bad}")
    return len(a)


# -- Mencius (#7) and Fast MultiPaxos (#8) ------------------------------------

MEN_PLANE = "mencius_vote"
FMP_PLANE = "fastmultipaxos_vote"
# (L, W, A) and (A, G, W) of the two vote planes at 10,002 and 100,002
# acceptors (the JAX configs' default widths, the flagship's cluster).
MEN_SHAPES = ((3334, 32, 3), (33334, 32, 3))
FMP_SHAPES = ((3, 3334, 32), (3, 33334, 32))


# The main-path route of each vote kernel: #7's vector route (a thread per
# 16-byte vector of cells), #8's scalar route (a thread a slot, every dense
# load first; a race chose it over 2 and 4 slots a thread).
MEN_ROUTE, FMP_ROUTE = "vector", "scalar"
# (shape, route) of the Mencius vote's checks: the main shapes, a ragged
# L, f = 2, 3 and 4, and W = 6 (L * W % 4 == 0) on the vector route; A = 11
# and L * W % 4 != 0 on the general route; each is also held on misaligned
# copies, which take the general route.
MEN_ROUTE_CASES = tuple((s, MEN_ROUTE) for s in MEN_SHAPES + (
    (7, 16, 3), (64, 32, 5), (4, 8, 7), (8, 4, 9), (4, 6, 3),
)) + (((7, 16, 11), "general"), ((5, 3, 3), "general"))
# (shape, block, route) of the FMP vote's checks: the main shapes, a ragged
# G, f = 2, 3 and 4, W = 6, an odd G * W and a block of part warps (cut to
# 96 threads) on the scalar route; A = 11 and 13 on the general route; each
# is also held on misaligned copies (the scalar route moves 4-byte words
# and bytes, so they keep their route).
FMP_ROUTE_CASES = tuple((s, 0, FMP_ROUTE) for s in FMP_SHAPES + (
    (3, 7, 16), (5, 64, 32), (7, 16, 16), (9, 16, 16), (3, 5, 6), (3, 5, 7),
)) + (((3, 334, 32), 100, FMP_ROUTE), ((11, 20, 32), 0, "general"),
      ((13, 7, 6), 0, "general"))


def fmp_statics(A: int, recovery_timeout: int = 10) -> dict:
    f = (A - 1) // 2
    return dict(fq=f + (f + 1) // 2 + 1, f=f, recovery_timeout=recovery_timeout)


def check_vote_kernels(registry, meo, fmo) -> dict:
    """Hold the Mencius and Fast MultiPaxos vote kernels against their
    plain versions on the card, tolerance zero, on each of their routes
    (``MEN_ROUTE_CASES``, ``FMP_ROUTE_CASES``; each case also on a
    misaligned copy), on random and edge inputs, each launch on the route
    its case names. Returns the largest error per plane (0)."""
    err = {MEN_PLANE: 0, FMP_PLANE: 0}
    for shape, route in MEN_ROUTE_CASES:
        for case in ("random", "all_now", "all_inf"):
            rng = np.random.default_rng(sum(shape))
            args = registry.to_torch(
                meo.example_mencius_vote_args(rng, *shape, case=case), "cuda"
            )
            for skew in (False, True):
                label = f"{MEN_PLANE}{shape} {case}{' misaligned' if skew else ''}"
                inputs = registry.misaligned(args) if skew else args
                got = one_route(registry, MEN_PLANE, "general" if skew else route,
                                label, meo.fused_mencius_vote, inputs, {})
                want = meo.reference_mencius_vote(*inputs)
                err[MEN_PLANE] = max(err[MEN_PLANE], outputs_equal(label, want, got))
        log(f"exact: {MEN_PLANE}{shape}, {route} route and general route "
            f"(misaligned)")
    for shape, block, route in FMP_ROUTE_CASES:
        st = fmp_statics(shape[0])
        kern = functools.partial(fmo.fused_fmp_vote, block=block)
        for case in fmo.EDGE_CASES:
            rng = np.random.default_rng(sum(shape))
            args = registry.to_torch(
                fmo.example_fmp_vote_args(rng, *shape, case=case), "cuda"
            )
            for skew in (False, True):
                label = f"{FMP_PLANE}{shape} {case}{' misaligned' if skew else ''}"
                inputs = registry.misaligned(args) if skew else args
                got = one_route(registry, FMP_PLANE, route, label, kern, inputs, st)
                want = fmo.reference_fmp_vote(*inputs, **st)
                err[FMP_PLANE] = max(err[FMP_PLANE], outputs_equal(label, want, got))
        log(f"exact: {FMP_PLANE}{shape} block {block} on {fmo.EDGE_CASES}, "
            f"{route} route, aligned and misaligned")
    return err


def mencius_run(ctx, cfg, warm: int, ticks: int, phase: str) -> dict:
    """Drive Mencius through its entry points: ``warm`` ticks, then
    ``ticks`` timed ticks with the launch counts zeroed just before and
    read just after. Raises unless the vote kernel ran once a tick, the
    invariants hold, and the global log, the real commands and the skips
    advanced."""
    registry, mb = ctx["registry"], ctx["mb"]
    sim = BatchedSim(mb, ctx["prng"], cfg, seed=0)
    if warm:
        sim.timed_run(warm)
    names = ("committed", "committed_real", "skips", "executed_global")
    before = sim.get(*names)
    registry.reset_launches()
    secs = sim.timed_run(ticks)
    launches = only_launches(registry, MEN_PLANE, ticks, phase)
    routes = only_route(registry, MEN_PLANE, ticks, phase, MEN_ROUTE)
    sim.assert_invariants(phase)
    d = dict(zip(names, (a - b for a, b in zip(sim.get(*names), before))))
    if d["executed_global"] <= 0 or d["committed_real"] <= 0 or d["skips"] <= 0:
        raise AssertionError(f"{phase}: no progress or no skips: {d}")
    p50, p99 = hist_percentiles(sim.state.lat_hist)
    line = {
        "phase": phase, "card": ctx["card"],
        "acceptors": cfg.num_leaders * cfg.group_size, "ticks": ticks,
        "seconds": secs, "ticks_per_s": ticks / secs,
        "committed_entries_per_s": d["committed_real"] / secs,
        "entries_per_tick": d["committed_real"] / ticks,
        "slots_per_tick_with_skips": d["committed"] / ticks,
        "skips_per_tick": d["skips"] / ticks,
        "executed_global_per_tick": d["executed_global"] / ticks,
        "commit_latency_p50_ticks": p50, "commit_latency_p99_ticks": p99,
        "launches": launches, "route_launches": routes,
    }
    log(json.dumps(line))
    return {"line": line, "sim": sim}


def fmp_run(ctx, cfg, warm: int, ticks: int, phase: str) -> dict:
    """Drive Fast MultiPaxos through its entry points (as
    :func:`mencius_run`). Raises unless the vote kernel ran once a tick,
    the invariants hold, commands completed, the jitter's conflicts went
    to recovery, and no choice contradicted the fast-committed ledger."""
    registry, fb = ctx["registry"], ctx["fb"]
    sim = BatchedSim(fb, ctx["prng"], cfg, seed=0)
    if warm:
        sim.timed_run(warm)
    s0 = sim.stats()
    registry.reset_launches()
    secs = sim.timed_run(ticks)
    launches = only_launches(registry, FMP_PLANE, ticks, phase)
    routes = only_route(registry, FMP_PLANE, ticks, phase, FMP_ROUTE)
    sim.assert_invariants(phase)
    s = sim.stats()
    done = s["cmds_done"] - s0["cmds_done"]
    recov = s["recoveries"] - s0["recoveries"]
    if done <= 0 or recov <= 0 or s["safety_violations"]:
        raise AssertionError(f"{phase}: {s}")
    p50, p99 = hist_percentiles(sim.state.lat_hist)
    if p50 != s["cmd_latency_p50_ticks"]:
        raise AssertionError(f"{phase}: p50 {p50} vs stats() {s}")
    line = {
        "phase": phase, "card": ctx["card"],
        "acceptors": cfg.num_groups * cfg.n, "ticks": ticks, "seconds": secs,
        "ticks_per_s": ticks / secs, "committed_entries_per_s": done / secs,
        "entries_per_tick": done / ticks,
        "slots_per_tick": (s["committed_slots"] - s0["committed_slots"]) / ticks,
        "fast_fraction": s["fast_fraction"], "recoveries": recov,
        "dups": s["dups"] - s0["dups"],
        "dropped_votes": s["dropped_votes"] - s0["dropped_votes"],
        "commit_latency_p50_ticks": p50, "commit_latency_p99_ticks": p99,
        "stats": s, "launches": launches, "route_launches": routes,
    }
    log(json.dumps(line))
    return {"line": line, "sim": sim}


def mencius_and_fmp(ctx) -> dict:
    """Phases 15-22: both backends at 10,002 acceptors (100 warm-up, 300
    timed ticks, profiled), at 100,002 (50 ticks), under a static fault
    plan (100 ticks), and card against CPU. Returns the main-path
    launches and tick times."""
    mb, fb, prng, card = ctx["mb"], ctx["fb"], ctx["prng"], ctx["card"]
    registry, tel_mod, FaultPlan = ctx["registry"], ctx["telemetry"], ctx["FaultPlan"]
    out = {}
    # 15-16. Mencius: the JAX config's defaults (mencius_batched.py:69-82)
    # with a quarter of the leaders unloaded, so skips always run.
    men = mb.BatchedMenciusConfig(
        f=1, num_leaders=3334, window=32, slots_per_tick=4, skip_threshold=16,
        lat_min=1, lat_max=3, retry_timeout=16, num_idle_leaders=834,
    )
    run = mencius_run(ctx, men, 100, 300, "mencius")
    out[MEN_PLANE] = run["line"]["launches"][MEN_PLANE]
    out["men_routes"] = run["line"]["route_launches"]
    out["mencius_tick_ms"] = run["line"]["seconds"] * 1e3 / 300
    prof = profile_ticks(
        run["sim"].run, run["sim"].sync, 20, card, "mencius_profile",
        kernel="mencius_vote",
    )
    log(json.dumps(prof))
    out["men_profiled_ms"] = prof["kernel_device_ms_per_launch"]
    del run
    men_big = dataclasses.replace(men, num_leaders=33334, num_idle_leaders=8334)
    out["mencius_100k_tick_ms"] = (
        mencius_run(ctx, men_big, 0, 50, "mencius_100k")["line"]["seconds"] * 20
    )
    torch.cuda.empty_cache()

    # 17. Mencius under a static plan: drops on every leg, jitter, leader
    # crashes, acceptor 2 cut from tick 20 to 60.
    plan = FaultPlan(
        drop_rate=0.05, jitter=1, crash_rate=0.01, revive_rate=0.2,
        partition=(0, 0, 1), partition_start=20, partition_heal=60,
    )
    sim = BatchedSim(mb, prng, dataclasses.replace(men, drop_rate=0.05, faults=plan))
    registry.reset_launches()
    secs = sim.timed_run(60)
    at_heal = sim.get("committed_real", "executed_global")
    secs += sim.timed_run(40)
    launches = only_launches(registry, MEN_PLANE, 100, "mencius faults")
    only_route(registry, MEN_PLANE, 100, "mencius faults", MEN_ROUTE)
    sim.assert_invariants("mencius faults")
    tel = tel_mod.summary(sim.state.telemetry)
    after = sim.get("committed_real", "executed_global")
    if tel["drops_total"] <= 0 or tel["retries_total"] <= 0 or not all(
        a > b for a, b in zip(after, at_heal)
    ):
        raise AssertionError(f"mencius faults: {tel}, {at_heal} -> {after}")
    log(json.dumps({
        "phase": "mencius_faults", "card": card, "ticks": 100, "seconds": secs,
        "ticks_per_s": 100 / secs, "committed_real": after[0],
        "committed_real_after_heal": after[0] - at_heal[0],
        "executed_global_after_heal": after[1] - at_heal[1],
        "drops": tel["drops_total"], "retries": tel["retries_total"],
        "leaders_down": int((~sim.state.fault_alive).sum()),
        "launches": launches,
    }))
    del sim

    # 18-19. Fast MultiPaxos: the JAX config's defaults
    # (fastmultipaxos_batched.py:67-78).
    fmp = fb.BatchedFastMultiPaxosConfig(
        f=1, num_groups=3334, window=32, cmd_window=32, cmds_per_tick=2,
        lat_min=1, lat_max=3, jitter=2, recovery_timeout=10, retry_timeout=12,
    )
    run = fmp_run(ctx, fmp, 100, 300, "fastmultipaxos")
    out[FMP_PLANE] = run["line"]["launches"][FMP_PLANE]
    out["fmp_routes"] = run["line"]["route_launches"]
    out["fmp_tick_ms"] = run["line"]["seconds"] * 1e3 / 300
    prof = profile_ticks(
        run["sim"].run, run["sim"].sync, 20, card, "fastmultipaxos_profile",
        kernel="fmp_vote",
    )
    log(json.dumps(prof))
    out["fmp_profiled_ms"] = prof["kernel_device_ms_per_launch"]
    del run
    fmp_big = dataclasses.replace(fmp, num_groups=33334)
    out["fmp_100k_tick_ms"] = (
        fmp_run(ctx, fmp_big, 0, 50, "fastmultipaxos_100k")["line"]["seconds"] * 20
    )
    torch.cuda.empty_cache()

    # 20. Fast MultiPaxos under the same static plan (proposer crashes).
    # The reference's own window invariant (acc_next >= head) can fail
    # while a cut acceptor catches up after the heal (ROADMAP.md §3), so
    # it is reported, not required.
    sim = BatchedSim(fb, prng, dataclasses.replace(fmp, faults=plan))
    registry.reset_launches()
    secs = sim.timed_run(60)
    (done_heal,) = sim.get("cmds_done")
    secs += sim.timed_run(40)
    launches = only_launches(registry, FMP_PLANE, 100, "fastmultipaxos faults")
    only_route(registry, FMP_PLANE, 100, "fastmultipaxos faults", FMP_ROUTE)
    sim.assert_invariants("fastmultipaxos faults", skip=("window_ok",))
    tel = tel_mod.summary(sim.state.telemetry)
    s = sim.stats()
    if tel["leader_changes_total"] <= 0 or s["cmds_done"] <= done_heal:
        raise AssertionError(f"fastmultipaxos faults: {tel}, {s}")
    log(json.dumps({
        "phase": "fastmultipaxos_faults", "card": card, "ticks": 100,
        "seconds": secs, "ticks_per_s": 100 / secs,
        "cmds_done_after_heal": s["cmds_done"] - done_heal,
        "leader_changes": tel["leader_changes_total"],
        "retries": tel["retries_total"], "drops": tel["drops_total"],
        "window_ok": sim.invariants()["window_ok"], "stats": s,
        "launches": launches,
    }))
    del sim
    torch.cuda.empty_cache()

    # 21-22. Card against CPU: the analysis configs under a plan of drop,
    # dup, jitter, crash and a healing cut (Mencius also idle and
    # Phase2a drops), seed 0, 120 ticks.
    small_plan = FaultPlan(
        drop_rate=0.1, dup_rate=0.1, jitter=1, crash_rate=0.05,
        revive_rate=0.3, partition=(0, 0, 1), partition_start=5,
        partition_heal=40,
    )
    for name, mod, extra in (
        ("mencius", mb, dict(idle_rate=0.3, drop_rate=0.05, skip_threshold=6)),
        ("fastmultipaxos", fb, {}),
    ):
        cfg = dataclasses.replace(mod.analysis_config(faults=small_plan), **extra)
        n = cards_equal(mod, prng, cfg, name)
        log(f"{name} card == cpu: {n} leaves equal after 120 ticks")
    return out


# -- Horizontal MultiPaxos (#9) and Scalog (#10) ------------------------------

HZ_PLANE = "horizontal_vote"
SC_PLANE = "scalog_cut_commit"
# (P, G, W) of the horizontal vote plane at 3334 and 33,334 groups (a pool
# of 2n = 6 rows, the active bank 10,002 / 100,002 acceptors), and (P, S)
# of the Scalog cut ring at 10,000 and 256 shards.
HZ_SHAPES = ((6, 3334, 32), (6, 33334, 32))
SC_SHAPES = ((8, 10000), (8, 256))
# ((P, S), route) at which the Scalog kernel is held against its plain
# version: the main shapes, the most shards the wrapper gives the cluster
# route and one more, 10x, a 2-cut ring, rings of 16 and 9 cuts (the
# cluster route's other row count) up to one trip of the cluster, and 17
# and 32 cuts, past the cluster; P = 40 and past take the general route
# too (check_repaired_shapes). next_cut values of the int32 edge.
SC_CHECK_SHAPES = (
    ((8, 256), "cluster"), ((8, 10000), "cluster"), ((8, 12000), "cluster"),
    ((8, 12001), "general"), ((8, 100000), "general"), ((2, 5), "cluster"),
    ((16, 8192), "cluster"), ((16, 8193), "general"), ((16, 777), "cluster"),
    ((9, 33), "cluster"), ((17, 64), "general"), ((32, 1000), "general"),
)
SC_INT32_EDGE_NEXT = (2**31 - 1, -(2**31) + 3, 2**31 - 7)


# (shape, route) of the horizontal vote's checks: the main shapes, f = 2
# and f = 3 pools, ragged G, n = 9 (the general instantiation), all on the
# vector route, and W = 6 on the general route; each is also held on
# misaligned copies, which take the general route.
HZ_ROUTE_CASES = tuple((s, "vector") for s in HZ_SHAPES + (
    (10, 1001, 32), (6, 77, 16), (14, 9, 8), (18, 77, 32),
)) + (((6, 77, 6), "general"),)


def hz_statics(P: int) -> dict:
    n = P // 2
    return dict(n=n, quorum=(n - 1) // 2 + 1)


def check_hz_sc_kernels(registry, hzo, sco) -> dict:
    """Hold the horizontal vote and Scalog cut-commit kernels against their
    plain versions on the card, tolerance zero: the main shapes, f=2 and
    f=3 pools, a ragged G, and for Scalog several CTAs, a 2-cut ring and
    the deepest ring the kernel takes, on random and edge inputs (the
    horizontal ones with and without a delivery plane). Returns the
    largest error per plane (0)."""
    err = {HZ_PLANE: 0, SC_PLANE: 0}
    # The route is chosen without a card, from ops/scalog.py's mirror of
    # what the launcher's cluster can take: hold the two together.
    from frankenpaxos_tpu_torch.ops import _build

    lib = _build.load()
    for P in range(0, 42):
        if lib.fpx_scalog_cluster_max_shards(P) != sco.cluster_max_shards(P):
            raise AssertionError(
                f"{SC_PLANE}: P={P} the launcher's cluster takes "
                f"{lib.fpx_scalog_cluster_max_shards(P)} shards, ops/scalog.py "
                f"says {sco.cluster_max_shards(P)}")
    log(f"{SC_PLANE}: cluster_max_shards equals the launcher's for P = 0..41")
    for shape, route in HZ_ROUTE_CASES:
        st = hz_statics(shape[0])
        for case in hzo.EDGE_CASES:
            rng = np.random.default_rng(sum(shape))
            args = list(registry.to_torch(
                hzo.example_horizontal_vote_args(rng, *shape, case=case), "cuda"
            ))
            for deliv in (True, False):
                if not deliv:
                    args[8] = None
                for skew in (False, True):
                    label = (f"{HZ_PLANE}{shape} {case} delivery={deliv}"
                             f"{' misaligned' if skew else ''}")
                    inputs = registry.misaligned(args) if skew else args
                    got = one_route(registry, HZ_PLANE, "general" if skew else route,
                                    label, hzo.fused_horizontal_vote, inputs, st)
                    want = hzo.reference_horizontal_vote(*inputs, **st)
                    err[HZ_PLANE] = max(err[HZ_PLANE], outputs_equal(label, want, got))
        log(f"exact: {HZ_PLANE}{shape} on {hzo.EDGE_CASES}, with and "
            f"without a delivery plane, {route} route and general route "
            f"(misaligned)")
    for shape, sc_route in SC_CHECK_SHAPES:
        for case in sco.EDGE_CASES:
            for seed in range(3):
                rng = np.random.default_rng(sum(shape) + seed)
                args = registry.to_torch(
                    sco.example_scalog_cut_commit_args(rng, *shape, case=case),
                    "cuda",
                )
                label = f"{SC_PLANE}{shape} {case} seed {seed}"
                got = one_route(registry, SC_PLANE, sc_route, label,
                                sco.fused_scalog_cut_commit, args, {})
                want = sco.reference_scalog_cut_commit(*args)
                err[SC_PLANE] = max(err[SC_PLANE], outputs_equal(label, want, got))
        # committed_cuts + P - 1 past INT_MAX: the issue order wraps in
        # int32 and two cuts share a ring slot (the plain version on the
        # CPU, whose scatter keeps the last, as the kernels do).
        for nc in SC_INT32_EDGE_NEXT:
            host = list(sco.example_scalog_cut_commit_args(
                np.random.default_rng(sum(shape)), *shape, case="all_committed"))
            host[5] = np.array(2**31 - 4, np.int32)
            host[6] = np.array(nc, np.int32)
            label = f"{SC_PLANE}{shape} int32 edge next_cut={nc}"
            got = one_route(registry, SC_PLANE, sc_route, label,
                            sco.fused_scalog_cut_commit,
                            registry.to_torch(host, "cuda"), {})
            want = tuple(x.cuda() for x in sco.reference_scalog_cut_commit(
                *registry.to_torch(host, "cpu")))
            err[SC_PLANE] = max(err[SC_PLANE], outputs_equal(label, want, got))
        log(f"exact: {SC_PLANE}{shape} on {sco.EDGE_CASES}, 3 seeds each, and "
            f"the int32 edge ({sc_route} route)")
    return err


def horizontal_run(ctx, cfg, warm: int, ticks: int, phase: str) -> dict:
    """Drive Horizontal MultiPaxos through its entry points: ``warm``
    ticks, then ``ticks`` timed ticks with the launch counts zeroed just
    before and read just after. Raises unless the vote kernel ran once a
    tick, the invariants hold, entries committed and no vote sat in the
    wrong bank."""
    registry, hb = ctx["registry"], ctx["hb"]
    sim = BatchedSim(hb, ctx["prng"], cfg, seed=0)
    if warm:
        sim.timed_run(warm)
    s0 = sim.stats()
    registry.reset_launches()
    secs = sim.timed_run(ticks)
    launches = only_launches(registry, HZ_PLANE, ticks, phase)
    routes = only_route(registry, HZ_PLANE, ticks, phase)
    sim.assert_invariants(phase)
    s = sim.stats()
    done = s["committed"] - s0["committed"]
    if done <= 0 or s["bank_violations"]:
        raise AssertionError(f"{phase}: {s}")
    p50, p99 = hist_percentiles(sim.state.lat_hist)
    if p50 != s["commit_latency_p50_ticks"]:
        raise AssertionError(f"{phase}: p50 {p50} vs stats() {s}")
    delta = {
        k: s[k] - s0[k]
        for k in ("reconfigs_proposed", "reconfigs_done", "alpha_stalls",
                  "boundary_stalls")
    }
    line = {
        "phase": phase, "card": ctx["card"],
        "acceptors": cfg.num_groups * cfg.n,
        "pool_rows": cfg.num_groups * cfg.pool, "ticks": ticks,
        "seconds": secs, "ticks_per_s": ticks / secs,
        "committed_entries_per_s": done / secs, "entries_per_tick": done / ticks,
        "entries_per_tick_max": cfg.num_groups * cfg.slots_per_tick,
        "commit_latency_p50_ticks": p50, "commit_latency_p99_ticks": p99,
        **delta, "bank_violations": s["bank_violations"],
        "invariants": sim.invariants(), "launches": launches,
        "route_launches": routes,
    }
    log(json.dumps(line))
    return {"line": line, "sim": sim}


def horizontal_churn(ctx, every: int, alpha: int, groups: int) -> dict:
    """One run of scripts/horizontal_churn.py (24 segments of 25 ticks, a
    fresh key per segment) at ``groups`` groups; committed entries per
    segment."""
    hb = ctx["hb"]
    cfg = hb.BatchedHorizontalConfig(
        f=1, num_groups=groups, window=32, slots_per_tick=2, lat_min=1,
        lat_max=3, reconfigure_every=every, alpha=alpha,
    )
    sim = BatchedSim(hb, ctx["prng"], cfg, seed=0)
    timeline = []
    t0 = time.perf_counter()
    for _ in range(24):
        (before,) = sim.get("committed")
        sim.run(25)
        timeline.append(sim.get("committed")[0] - before)
    secs = time.perf_counter() - t0
    sim.assert_invariants(f"horizontal churn every={every} alpha={alpha}")
    return {
        "alpha": alpha, "reconfigure_every": every, "ticks_per_s": 600 / secs,
        "entries_per_tick": sum(timeline[4:]) / (20 * 25),
        "timeline_committed_per_segment": timeline, "stats": sim.stats(),
    }


def scalog_run(ctx, cfg, warm: int, ticks: int, phase: str) -> dict:
    """Drive Scalog through its entry points (as :func:`horizontal_run`).
    Raises unless the cut-commit kernel ran once a tick, the invariants
    hold, and cuts committed and the global log grew."""
    registry, sb = ctx["registry"], ctx["sb"]
    sim = BatchedSim(sb, ctx["prng"], cfg, seed=0)
    if warm:
        sim.timed_run(warm)
    names = ("global_len", "committed_cuts", "lat_sum", "lat_count")
    before = sim.get(*names)
    registry.reset_launches()
    secs = sim.timed_run(ticks)
    launches = only_launches(registry, SC_PLANE, ticks, phase)
    routes = only_route(registry, SC_PLANE, ticks, phase, "cluster")
    sim.assert_invariants(phase)
    d = dict(zip(names, (a - b for a, b in zip(sim.get(*names), before))))
    if d["global_len"] <= 0 or d["committed_cuts"] <= 0:
        raise AssertionError(f"{phase}: no progress: {d}")
    p50, p99 = hist_percentiles(sim.state.lat_hist)
    line = {
        "phase": phase, "card": ctx["card"], "shards": cfg.num_shards,
        "ticks": ticks, "seconds": secs, "ticks_per_s": ticks / secs,
        "ordered_records_per_s": d["global_len"] / secs,
        "global_len_per_tick": d["global_len"] / ticks,
        "committed_cuts_per_tick": d["committed_cuts"] / ticks,
        "mean_ordering_lag_ticks": d["lat_sum"] / d["lat_count"],
        "lag_p50_ticks": p50, "lag_p99_ticks": p99,
        "invariants": sim.invariants(), "launches": launches,
        "route_launches": routes,
    }
    log(json.dumps(line))
    return {"line": line, "sim": sim}


def sweep_split(ctx, phase: str, tick_ms: float, shapes) -> dict:
    """The threefry sweeps of a tick at its shapes (CUDA events), and
    their share of the tick."""
    prng = ctx["prng"]
    sweeps = {
        "x".join(map(str, s)): time_ms(
            lambda s=s: prng.bits(prng.PRNGKey(0), s, "cuda"), reps=10
        )
        for s in shapes
    }
    line = {
        "phase": phase, "card": ctx["card"], "tick_ms": tick_ms,
        "threefry_sweep_ms": sweeps,
        "threefry_share": sum(sweeps.values()) / tick_ms,
    }
    log(json.dumps(line))
    return line


def horizontal_and_scalog(ctx) -> dict:
    """Phases 24-31: Horizontal MultiPaxos at 3334 groups (100 warm-up and
    300 timed ticks, profiled), its churn timelines, 33,334 groups and a
    static fault plan; Scalog at 256 and 10,000 shards and under a fault
    plan; both card against CPU. Returns the main-path launches, tick
    times and the kernels' profiled device times."""
    hb, sb, prng, card = ctx["hb"], ctx["sb"], ctx["prng"], ctx["card"]
    registry, tel_mod, FaultPlan = ctx["registry"], ctx["telemetry"], ctx["FaultPlan"]
    out = {}
    # 24. Horizontal: the churning shape of
    # scripts/batched_backends_snapshot.py (f=1, W=32, K=2, alpha 16, a
    # reconfiguration every 50 ticks) at 3334 groups: 20,004 pool rows,
    # 10,002 acceptors in the active bank.
    hz = hb.BatchedHorizontalConfig(
        f=1, num_groups=3334, window=32, slots_per_tick=2, alpha=16,
        lat_min=1, lat_max=3, reconfigure_every=50,
    )
    run = horizontal_run(ctx, hz, 100, 300, "horizontal")
    out[HZ_PLANE] = run["line"]["launches"][HZ_PLANE]
    out["hz_routes"] = run["line"]["route_launches"]
    out["hz_tick_ms"] = run["line"]["seconds"] * 1e3 / 300
    prof = profile_ticks(
        run["sim"].run, run["sim"].sync, 20, card, "horizontal_profile",
        kernel="horizontal_vote",
    )
    log(json.dumps(prof))
    out["hz_profiled_ms"] = prof["kernel_device_ms_per_launch"]
    del run

    # 25. The churn timelines of scripts/horizontal_churn.py at 3334
    # groups: churn-free, every 50 ticks at alpha 16 and at alpha 4.
    free = horizontal_churn(ctx, 0, 16, 3334)
    rows = {"churn_free": free}
    for name, alpha in (("churn_alpha16", 16), ("churn_alpha4", 4)):
        rows[name] = horizontal_churn(ctx, 50, alpha, 3334)
        rows[name]["throughput_retained"] = (
            rows[name]["entries_per_tick"] / free["entries_per_tick"]
        )
    if rows["churn_alpha4"]["stats"]["boundary_stalls"] <= 0 or (
        rows["churn_alpha16"]["stats"]["reconfigs_done"] <= 0
    ):
        raise AssertionError(f"horizontal churn: {rows}")
    log(json.dumps({"phase": "horizontal_churn", "card": card, **rows}))

    # 26. 33,334 groups (100,002 acceptors in the active bank), cold.
    big = dataclasses.replace(hz, num_groups=33334)
    out["hz_100k_tick_ms"] = (
        horizontal_run(ctx, big, 0, 50, "horizontal_100k")["line"]["seconds"] * 20
    )
    torch.cuda.empty_cache()

    # 27. Under a static plan: drops on every leg, jitter, leader crashes,
    # pool row 2 cut from tick 20 to 60.
    plan = FaultPlan(
        drop_rate=0.05, jitter=1, crash_rate=0.01, revive_rate=0.2,
        partition=(0, 0, 1, 0, 0, 0), partition_start=20, partition_heal=60,
    )
    sim = BatchedSim(hb, prng, dataclasses.replace(hz, faults=plan))
    registry.reset_launches()
    secs = sim.timed_run(60)
    (at_heal,) = sim.get("committed")
    secs += sim.timed_run(40)
    launches = only_launches(registry, HZ_PLANE, 100, "horizontal faults")
    only_route(registry, HZ_PLANE, 100, "horizontal faults")
    sim.assert_invariants("horizontal faults")
    tel = tel_mod.summary(sim.state.telemetry)
    s = sim.stats()
    if tel["retries_total"] <= 0 or s["committed"] <= at_heal or s["bank_violations"]:
        raise AssertionError(f"horizontal faults: {tel}, {s}")
    log(json.dumps({
        "phase": "horizontal_faults", "card": card, "ticks": 100,
        "seconds": secs, "ticks_per_s": 100 / secs,
        "committed_after_heal": s["committed"] - at_heal,
        "retries": tel["retries_total"],
        "leaders_down": int((~sim.state.fault_alive).sum()), "stats": s,
        "launches": launches,
    }))
    del sim
    torch.cuda.empty_cache()

    # 28. Scalog: the snapshot's 256 shards (appends 8, P=8, a cut every 2
    # ticks: scripts/batched_backends_snapshot.py), and 10,000 shards.
    sc = sb.BatchedScalogConfig(num_shards=256, appends_per_tick=8)
    sc_small = scalog_run(ctx, sc, 100, 300, "scalog_256")
    out["sc_256_tick_ms"] = sc_small["line"]["seconds"] * 1e3 / 300
    del sc_small
    run = scalog_run(
        ctx, dataclasses.replace(sc, num_shards=10000), 100, 300, "scalog"
    )
    out[SC_PLANE] = run["line"]["launches"][SC_PLANE]
    out["sc_routes"] = run["line"]["route_launches"]
    out["sc_tick_ms"] = run["line"]["seconds"] * 1e3 / 300
    prof = profile_ticks(
        run["sim"].run, run["sim"].sync, 20, card, "scalog_profile",
        kernel="scalog_",
    )
    log(json.dumps(prof))
    out["sc_profiled_ms"] = prof["kernel_device_ms_per_launch"]
    del run

    # 29. Scalog under a static plan at 256 shards: the ordering round's
    # drops and jitter, aggregator crashes, shard 2 cut from tick 20 to
    # 60 (no cut is issued while the cut is live).
    side = tuple(1 if s == 2 else 0 for s in range(256))
    sim = BatchedSim(sb, prng, dataclasses.replace(sc, faults=FaultPlan(
        drop_rate=0.05, jitter=1, crash_rate=0.01, revive_rate=0.2,
        partition=side, partition_start=20, partition_heal=60,
    )))
    registry.reset_launches()
    secs = sim.timed_run(20)
    at_cut = sim.get("next_cut", "global_len")
    secs += sim.timed_run(40)
    at_heal = sim.get("next_cut", "global_len")
    secs += sim.timed_run(40)
    after = sim.get("next_cut", "global_len")
    launches = only_launches(registry, SC_PLANE, 100, "scalog faults")
    only_route(registry, SC_PLANE, 100, "scalog faults", "cluster")
    sim.assert_invariants("scalog faults")
    if at_heal[0] != at_cut[0] or not after[1] > at_heal[1]:
        raise AssertionError(f"scalog faults: {at_cut} {at_heal} {after}")
    log(json.dumps({
        "phase": "scalog_faults", "card": card, "ticks": 100, "seconds": secs,
        "ticks_per_s": 100 / secs, "cuts_issued_during_cut": at_heal[0] - at_cut[0],
        "global_len_after_heal": after[1] - at_heal[1],
        "agg_alive": bool(sim.state.agg_alive), "launches": launches,
    }))
    del sim

    # 30. Card against CPU: the analysis configs under a plan of drop,
    # dup, jitter, crash and a healing cut (horizontal reconfiguring
    # every 9 ticks), seed 0, 120 ticks.
    for name, mod, side, extra in (
        ("horizontal", hb, (0, 0, 0, 1, 0, 0), dict(reconfigure_every=9)),
        ("scalog", sb, (0, 0, 0, 1), {}),
    ):
        small_plan = FaultPlan(
            drop_rate=0.1, dup_rate=0.1, jitter=1, crash_rate=0.05,
            revive_rate=0.3, partition=side, partition_start=5,
            partition_heal=40,
        )
        cfg = dataclasses.replace(mod.analysis_config(faults=small_plan), **extra)
        n = cards_equal(mod, prng, cfg, name)
        log(f"{name} card == cpu: {n} leaves equal after 120 ticks")
    return out


def hz_sc_kernel_rows(ctx, launches: dict, max_err: dict, hs: dict) -> list:
    """Kernel rows for #9 and #10: the kernel alone, the wrapper and the
    plain version at the main shapes, beside the least time for the bytes
    these inputs need (``ops/horizontal.py``
    ``horizontal_vote_needed_bytes``; the all-bytes figure is ``bytes``);
    #9 with :func:`vector_route_keys`, #10 with its launch floor
    (``floor_ms_cold`` / ``_clean`` / ``_warm``: the same memset and grid
    running a kernel that does nothing) and its cold time over it."""
    registry, hzo, sco = ctx["registry"], ctx["hzo"], ctx["sco"]
    rows = []
    for plane, mod, shapes, suffix in (
        (HZ_PLANE, hzo, HZ_SHAPES, "_100k"), (SC_PLANE, sco, SC_SHAPES, "_256"),
    ):
        row = {
            "name": plane, "route": "cuda",
            "source": registry.PLANES[plane].source,
            "replaces": registry.PLANES[plane].replaces,
            "launches": launches[plane], "launches_per_tick": 1,
            "exact": True, "max_abs_err": max_err[plane],
            "device_ms_profiled": hs["hz_profiled_ms" if plane == HZ_PLANE
                                     else "sc_profiled_ms"],
        }
        for i, shape in enumerate(shapes):
            rng = np.random.default_rng(7)
            if plane == HZ_PLANE:
                P, G, W = shape
                st = hz_statics(P)
                args = list(registry.to_torch(
                    hzo.example_horizontal_vote_args(rng, *shape), "cuda"
                ))
                args[8] = None  # the healthy tick passes no delivery plane
                launch, outs = hzo.prepared_launch(*args, **st)
                needed = hzo.horizontal_vote_needed_bytes(args, **st)
                cells, slots = P * G * W, G * W
                ops = cells * 12 + slots * 8
                kern, plain = hzo.fused_horizontal_vote, hzo.reference_horizontal_vote
            else:
                P, S = shape
                st = {}
                args = registry.to_torch(
                    sco.example_scalog_cut_commit_args(rng, *shape), "cuda"
                )
                launch, outs = sco.prepared_launch(*args)
                n_commit = int(sco.reference_scalog_cut_commit(*args)[1].sum())
                needed = sco.scalog_cut_commit_needed_bytes(*args)
                ops = S * max(1, n_commit) * 4
                kern, plain = sco.fused_scalog_cut_commit, sco.reference_scalog_cut_commit
            moved = nbytes(args) + nbytes(outs)
            timed = _timed_vote_row(kern, plain, launch, args, st, needed, moved, ops)
            if plane == HZ_PLANE:
                timed.update(vector_route_keys("hz", args, st, launch, needed, moved))
            else:
                # The launch floors, timed the same ways: the general
                # route's memset and grid with a kernel that does nothing
                # (csrc/scalog.cu fpx_scalog_floor_launch), and the route's
                # own launch shape with one, no memset
                # (fpx_scalog_one_floor_launch). The function needs one
                # launch: bound_ms_one_launch is the larger of the byte
                # bound and the one-launch floor.
                floor = device_times(launch.floor)
                one = device_times(launch.floor_one)
                from frankenpaxos_tpu_torch.harness import chain_race as race

                general = race.launcher(
                    "sc", None, race.general_edit("sc"), launch.packed)
                timed.update(
                    launch_route=launch.route,
                    floor_ms_cold=floor["device_ms_cold"],
                    floor_ms_clean=floor["device_ms_cold_clean"],
                    floor_ms_warm=floor["device_ms_warm"],
                    floor_ratio_cold=timed["device_ms_cold"] / floor["device_ms_cold"],
                    floor_one_ms_cold=one["device_ms_cold"],
                    floor_one_ms_clean=one["device_ms_cold_clean"],
                    floor_one_ms_warm=one["device_ms_warm"],
                    floor_one_ratio_cold=timed["device_ms_cold"] / one["device_ms_cold"],
                    bound_ms_one_launch=max(timed["bound_ms"], one["device_ms_cold"]),
                    general_device_ms_cold=device_times(general)["device_ms_cold"],
                    device_events_20_calls=trace_one_call(launch),
                )
            key = "" if i == 0 else suffix
            row.update({f"{k}{key}": v for k, v in timed.items()})
            row["shape" + key] = list(shape)
        row["route_launches"] = hs["hz_routes" if plane == HZ_PLANE else "sc_routes"]
        row["library_ms"] = None
        rows.append(row)
    return rows


def trace_one_call(launch, calls: int = 20) -> dict:
    """The device events (kernels, memsets) of ``calls`` calls of
    ``launch()`` in the profiler's trace, ``{name: count}`` (a warm-up
    step first: the profiler may still miss some of what is launched just
    after it starts). Raises unless the calls launched one kernel and
    nothing else (no memset): one name, at most ``calls`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                launch()
            torch.cuda.synchronize()
            prof.step()
    events = {e.key[:80]: e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.key.startswith("ProfilerStep")}
    if len(events) != 1 or not 0 < sum(events.values()) <= calls:
        raise AssertionError(f"{calls} calls' device events: {events}")
    return events


def vector_route_keys(plane: str, args, statics, launch, needed: int,
                      moved: int, route_bytes: int = 0) -> dict:
    """What the rows of the kernels with a redesigned route and the general
    kernel they were first written as (#7, #8, #9 and #11: ``plane``
    "men", "fmp", "hz" or "craq") add: the route the launch took; the cold time of the general
    route on the same inputs (the parent commit's kernel, its pointers
    ``__restrict__``; ``harness/chain_race.py --parent`` times the
    parent's own build); the kernel in a
    steady stream (``harness/chain_race.py`` ``kernel_steady_ms``); and
    the cold times of a torch copy of the bytes the inputs need and of
    every input and output byte; with ``route_bytes`` (#7 and #8, whose
    routes read more than the function needs), those bytes and the cold
    times of a copy of them (``_route``)."""
    from frankenpaxos_tpu_torch.harness import chain_race as race

    general = race.launcher(plane, None, race.general_edit(plane), launch.packed)
    return {
        "launch_route": launch.route,
        "general_device_ms_cold": device_times(general)["device_ms_cold"],
        "steady_ms": race.kernel_steady_ms(plane, args, statics),
        **yardstick_keys(needed),
        **yardstick_keys(moved, "_all"),
        **({"route_bytes": route_bytes, **yardstick_keys(route_bytes, "_route")}
           if route_bytes else {}),
    }


def _timed_vote_row(kern, plain, launch, args, statics, needed, moved, ops) -> dict:
    bytes_ms = needed / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {
        "ms": time_ms(launch),
        **device_times(launch),
        "wrapper_ms": time_ms(lambda: kern(*args, **statics)),
        "plain_ms": time_ms(lambda: plain(*args, **statics), reps=10),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": moved,
        "bound_bytes": needed,
    }


def vote_kernel_rows(ctx, launches: dict, max_err: dict, mf: dict) -> list:
    """Kernel rows for #7 and #8: the kernel alone, the wrapper and the
    plain version at the 10k and 100k main shapes, beside the least time
    for the bytes the function needs on these inputs (``ops/mencius.py``
    ``mencius_vote_needed_bytes``, ``ops/fastmultipaxos.py``
    ``fmp_vote_needed_bytes``; the all-bytes figure is ``bytes``), with
    :func:`vector_route_keys` (and the bytes the main-path routes move,
    ``mencius_vote_route_bytes``, ``fmp_vote_route_bytes``), the main
    path's route launches and the profiler's in-tick device time a
    launch."""
    registry, meo, fmo = ctx["registry"], ctx["meo"], ctx["fmo"]
    rows = []
    for plane, mod, shapes, tag in (
        (MEN_PLANE, meo, MEN_SHAPES, "men"), (FMP_PLANE, fmo, FMP_SHAPES, "fmp"),
    ):
        row = {
            "name": plane, "route": "cuda",
            "source": registry.PLANES[plane].source,
            "replaces": registry.PLANES[plane].replaces,
            "launches": launches[plane], "launches_per_tick": 1,
            "exact": True, "max_abs_err": max_err[plane],
            "device_ms_profiled": mf[f"{tag}_profiled_ms"],
            "route_launches": mf[f"{tag}_routes"],
        }
        for i, shape in enumerate(shapes):
            rng = np.random.default_rng(7)
            if plane == MEN_PLANE:
                L, W, A = shape
                args = registry.to_torch(meo.example_mencius_vote_args(rng, *shape), "cuda")
                st = {}
                needed = meo.mencius_vote_needed_bytes(args)
                route_bytes = meo.mencius_vote_route_bytes(args)
                ops = L * W * A * 8 + L * W * 3
                kern, plain = meo.fused_mencius_vote, meo.reference_mencius_vote
            else:
                A, G, W = shape
                st = fmp_statics(A)
                args = registry.to_torch(fmo.example_fmp_vote_args(rng, *shape), "cuda")
                needed = fmo.fmp_vote_needed_bytes(args, **st)
                route_bytes = fmo.fmp_vote_route_bytes(args, **st)
                ops = G * W * (6 * A * A + 10 * A + 40)
                kern, plain = fmo.fused_fmp_vote, fmo.reference_fmp_vote
            launch, outs = mod.prepared_launch(*args, **st)
            moved = nbytes(args) + nbytes(outs)
            timed = _timed_vote_row(kern, plain, launch, args, st, needed, moved, ops)
            timed.update(vector_route_keys(tag, args, st, launch, needed, moved,
                                           route_bytes))
            suffix = "" if i == 0 else "_100k"
            row.update({f"{k}{suffix}": v for k, v in timed.items()})
            row["shape" + suffix] = list(shape)
        row["library_ms"] = None
        rows.append(row)
    return rows


def check_repaired_shapes(ctx) -> dict:
    """Phase 32: every kernel of #1-#5 and #8-#10 at the shapes the JAX
    kernels run and the templated fast paths do not cover (A = 11, W =
    2048, n = 9, P = 40, and ragged neighbours), bit for bit against its
    plain version, and the first shape of each timed (the kernel alone on
    CUDA events, and its plain version); then f=5 MultiPaxos and a 40-cut
    Scalog pipeline for 50 ticks, card against CPU leaf for leaf. Returns
    ``(largest error per plane (0), timings per plane)``."""
    registry, mp, czo = ctx["registry"], ctx["mp"], ctx["czo"]
    fmo, hzo, sco = ctx["fmo"], ctx["hzo"], ctx["sco"]
    err, timing = {}, {}

    def check(plane, label, want, got):
        err[plane] = max(err.get(plane, 0), outputs_equal(label, want, got))

    def timed(plane, shape, launch, plain):
        timing.setdefault(plane, {})["x".join(map(str, shape))] = {
            "ms": time_ms(launch), "plain_ms": time_ms(plain, reps=5),
        }

    mp_planes = {
        "tick": ("multipaxos_fused_tick", mp.fused_tick, mp.reference_fused_tick),
        "vote": ("multipaxos_vote_quorum", mp.fused_vote_quorum,
                 mp.reference_vote_quorum),
        "dispatch": ("multipaxos_dispatch", mp.fused_mp_dispatch,
                     mp.reference_mp_dispatch),
        "p1": ("multipaxos_p1_promise", mp.fused_p1_promise,
               mp.reference_p1_promise),
    }
    for shape in ((11, 3334, 256), (3, 512, 2048), (13, 7, 1030)):
        for which, (plane, kern, plain) in mp_planes.items():
            args, st = plane_args(mp, which, shape, seed=sum(shape))
            got = kern(*args, **st)
            torch.cuda.synchronize()
            check(plane, f"{plane}{shape}", plain(*args, **st), got)
            if shape[1] >= 512:
                launch, _ = mp.prepared_launch(plane, *args, **st)
                timed(plane, shape, launch, lambda: plain(*args, **st))
        log(f"exact (repaired): the four MultiPaxos kernels at {shape}")
    cz_plane = "compartmentalized_grid_vote"
    for shape in ((2, 2, 3, 512, 2048), (2, 3, 2, 7, 1030)):
        rng = np.random.default_rng(sum(shape))
        args = registry.to_torch(czo.example_grid_vote_args(rng, *shape), "cuda")
        got = czo.fused_grid_vote(*args, retry_timeout=16)
        torch.cuda.synchronize()
        check(cz_plane, f"{cz_plane}{shape}",
              czo.reference_grid_vote(*args, retry_timeout=16), got)
        if shape[3] >= 512:
            launch, _ = czo.prepared_launch(*args, retry_timeout=16)
            timed(cz_plane, shape, launch,
                  lambda: czo.reference_grid_vote(*args, retry_timeout=16))
        log(f"exact (repaired): {cz_plane}{shape}")
    for plane, mod, shapes, make, statics, kern, plain in (
        (FMP_PLANE, fmo, ((11, 3334, 32), (13, 77, 16)), fmo.example_fmp_vote_args,
         lambda s: fmp_statics(s[0]), fmo.fused_fmp_vote, fmo.reference_fmp_vote),
        (HZ_PLANE, hzo, ((18, 3334, 32), (22, 77, 16)),
         hzo.example_horizontal_vote_args, lambda s: hz_statics(s[0]),
         hzo.fused_horizontal_vote, hzo.reference_horizontal_vote),
        (SC_PLANE, sco, ((40, 10000), (70, 333), (33, 64)),
         sco.example_scalog_cut_commit_args, lambda s: {},
         sco.fused_scalog_cut_commit, sco.reference_scalog_cut_commit),
    ):
        for shape in shapes:
            for case in mod.EDGE_CASES:
                rng = np.random.default_rng(sum(shape))
                args = registry.to_torch(make(rng, *shape, case=case), "cuda")
                got = kern(*args, **statics(shape))
                torch.cuda.synchronize()
                check(plane, f"{plane}{shape} {case}", plain(*args, **statics(shape)), got)
                if shape == shapes[0] and case == "random":
                    launch, _ = mod.prepared_launch(*args, **statics(shape))
                    timed(plane, shape, launch,
                          lambda: plain(*args, **statics(shape)))
            log(f"exact (repaired): {plane}{shape} on {mod.EDGE_CASES}")

    # Whole runs at repaired shapes: f=5 MultiPaxos (A = 11) through the
    # transport, and Scalog with 40 cuts in flight.
    mpb, TpuSimTransport = ctx["mpb"], ctx["TpuSimTransport"]
    cfg = mpb.BatchedMultiPaxosConfig(
        f=5, num_groups=4, window=16, slots_per_tick=2, drop_rate=0.05,
        retry_timeout=8,
    )
    on_card = TpuSimTransport(cfg, seed=0)
    on_cpu = TpuSimTransport(cfg, seed=0, device="cpu")
    on_card.run(50)
    on_cpu.run(50)
    a, b = mpb.state_to_numpy(on_card.state), mpb.state_to_numpy(on_cpu.state)
    bad = [k for k in a if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
    if bad or on_card.stats() != on_cpu.stats() or on_card.committed() <= 0:
        raise AssertionError(f"f=5 multipaxos card vs CPU: leaves differ: {bad}")
    log(f"f=5 multipaxos card == cpu: {len(a)} leaves equal after 50 ticks, "
        f"committed {on_card.committed()}")
    sb = ctx["sb"]
    cfg = dataclasses.replace(sb.analysis_config(), max_inflight_cuts=40)
    n = cards_equal(sb, ctx["prng"], cfg, "scalog P=40", ticks=50)
    log(f"scalog P=40 card == cpu: {n} leaves equal after 50 ticks")
    log(json.dumps({"phase": "repaired_shapes_timing", "card": ctx["card"],
                    **timing}))
    return err, timing


# -- CRAQ (#11) and BPaxos (#12) ----------------------------------------------

CR_PLANE = "craq_chain"
DG_PLANE = "depgraph_execute"
# (N, W, L, KV) of the chain plane: the snapshot's per-chain shape at 2,500
# chains (10,000 chain nodes) and 25,000; (B, V) of the execute plane: 5
# replicas over the 5 x 64 window, and over 5 x 256; then the largest
# window whose working set fits in a block's opted-in shared memory and
# the first one on the global scratch.
CR_SHAPES = ((2500, 16, 4, 64), (25000, 16, 4, 64))
DG_SHAPES = ((5, 320), (5, 1280))
DG_BOUNDARY = ((2, 1314), (2, 1315))


# (shape, route) of the chain kernel's checks: the main shapes, the
# snapshot's 256 chains, ragged shapes and the largest rows the vector
# route holds in shared memory (L*KV = 6144) on the vector route; rows of
# 15 columns (L*KV % 4 != 0) and of 6148 (past the route's shared memory)
# on the general route; each also on misaligned copies (general).
CR_ROUTE_CASES = tuple((s, "vector") for s in CR_SHAPES + (
    (256, 16, 4, 64), (7, 5, 3, 8), (40, 12, 4, 8), (3, 8, 2, 3072),
)) + (((33, 40, 5, 3), "general"), ((3, 8, 2, 3074), "general"))


def craq_statics(L: int, KV: int, partition: str = "none") -> dict:
    side, start, heal = {
        "none": ((), 0, -1),
        "heals": ((0,) * (L - 2) + (1, 0), 10, 55),
        "never_heals": ((0, 1) + (0,) * (L - 2), 30, -1),
    }[partition]
    return dict(tail=L - 1, num_keys=KV, side=side, partition_start=start,
                partition_heal=heal)


def check_craq_dg_kernels(ctx) -> dict:
    """Hold the chain and execute kernels against their plain versions on
    the card, tolerance zero: the chain kernel at its main shapes, the
    snapshot's 256 chains and ragged shapes, on random and edge inputs,
    with no partition, one that heals and one that never heals; the
    execute kernel at V = 320 and 1280, ragged V, and either side of the
    shared-memory limit (1314 shared, 1315 on the global scratch), on
    random and edge inputs (the long path among them) and on an
    all-active dense graph at V = 1280, with a per-replica and a stride-0
    shared adjacency, and against the host oracle at V = 320, 1280, 1314
    and 1315 and on the long path and the dense graph. Returns the largest
    error per plane (0)."""
    registry, cro, dgo = ctx["registry"], ctx["cro"], ctx["dgo"]
    err = {CR_PLANE: 0, DG_PLANE: 0}
    for shape, route in CR_ROUTE_CASES:
        N, W, L, KV = shape
        for case in cro.EDGE_CASES:
            rng = np.random.default_rng(sum(shape))
            args = registry.to_torch(cro.example_craq_chain_args(rng, *shape, case=case), "cuda")
            for partition in ("none", "heals", "never_heals"):
                st = craq_statics(L, KV, partition)
                for skew in (False, True):
                    label = (f"{CR_PLANE}{shape} {case} {partition}"
                             f"{' misaligned' if skew else ''}")
                    inputs = registry.misaligned(args) if skew else args
                    got = one_route(registry, CR_PLANE, "general" if skew else route,
                                    label, cro.fused_craq_chain, inputs, st)
                    want = cro.reference_craq_chain(*inputs, **st)
                    err[CR_PLANE] = max(err[CR_PLANE], outputs_equal(label, want, got))
        log(f"exact: {CR_PLANE}{shape} on {cro.EDGE_CASES} x 3 partitions, "
            f"{route} route and general route (misaligned)")
    def check_dg(B, V, case, graphs, oracle):
        adj_np, com_np, act_np = graphs
        adj = torch.from_numpy(adj_np.view(np.int32).copy()).cuda()
        com, act = torch.from_numpy(com_np).cuda(), torch.from_numpy(act_np).cuda()
        for label, a in (("", adj), (" shared", adj[:1].expand(adj.shape))):
            got = dgo.fused_depgraph_execute(a, com, act)
            torch.cuda.synchronize()
            want = dgo.reference_depgraph_execute(a, com, act)
            label = f"{DG_PLANE}{(B, V)} {case}{label}"
            err[DG_PLANE] = max(err[DG_PLANE], outputs_equal(label, want, got))
        if oracle:
            got = dgo.fused_depgraph_execute(adj, com, act)
            for b in range(B):
                want = dgo.oracle_execute(adj_np[b], com_np[b], act_np[b])
                for name, o, g in zip(dgo.DEPGRAPH_OUTS, want, got):
                    if not np.array_equal(o, g[b].cpu().numpy()):
                        raise AssertionError(f"{DG_PLANE}{(B, V)} {case} graph {b}: "
                                             f"{name} differs from the oracle")
            log(f"exact: {DG_PLANE}{(B, V)} {case} against the host oracle")

    for B, V in DG_SHAPES + ((3, 33), (4, 600)) + DG_BOUNDARY:
        for case in dgo.EDGE_CASES:
            graphs = dgo.example_depgraph_args(np.random.default_rng(V), B, V, case=case)
            oracle = (case == "random" and (B, V) in DG_SHAPES + DG_BOUNDARY) or (
                case == "long_path" and V == 1280
            )
            check_dg(B, V, case, graphs, oracle)
        log(f"exact: {DG_PLANE}{(B, V)} on {dgo.EDGE_CASES}, own and shared rows, "
            f"{'shared memory' if dgo.working_set(V)[1] else 'global scratch'}")
    # An all-active dense graph at V = 1280 (one SCC), with its commits at
    # random and all committed.
    B, V = DG_SHAPES[1]
    adj_np, com_np, act_np = dgo.example_depgraph_args(
        np.random.default_rng(V + 1), B, V, density=0.5
    )
    act_np = np.ones_like(act_np)
    for case, com in (("dense", com_np), ("dense all_committed", np.ones_like(com_np))):
        check_dg(B, V, case, (adj_np, com, act_np), oracle=True)
    return err


def craq_run(ctx, cfg, warm: int, ticks: int, phase: str) -> dict:
    """Drive CRAQ through its entry points: ``warm`` ticks, then ``ticks``
    timed ticks with the launch counts zeroed just before and read just
    after. Raises unless the chain kernel ran once a tick, every invariant
    holds, and writes and reads completed."""
    registry, cb = ctx["registry"], ctx["cb"]
    sim = BatchedSim(cb, ctx["prng"], cfg, seed=0)
    if warm:
        sim.timed_run(warm)
    s0 = sim.stats()
    registry.reset_launches()
    secs = sim.timed_run(ticks)
    launches = only_launches(registry, CR_PLANE, ticks, phase)
    routes = only_route(registry, CR_PLANE, ticks, phase)
    sim.assert_invariants(phase)
    s = sim.stats()
    writes = s["writes_done"] - s0["writes_done"]
    reads = s["reads_done"] - s0["reads_done"]
    if writes <= 0 or (cfg.reads_per_tick and reads <= 0) or s["read_lin_violations"]:
        raise AssertionError(f"{phase}: {s}")
    wp50, wp99 = hist_percentiles(sim.state.write_lat_hist)
    rp50, rp99 = hist_percentiles(sim.state.read_lat_hist)
    if wp50 != s["write_latency_p50_ticks"]:
        raise AssertionError(f"{phase}: p50 {wp50} vs stats() {s}")
    clean = s["reads_clean"] - s0["reads_clean"]
    dirty = s["reads_dirty"] - s0["reads_dirty"]
    line = {
        "phase": phase, "card": ctx["card"], "chains": cfg.num_chains,
        "chain_nodes": cfg.num_chains * cfg.chain_len, "ticks": ticks,
        "seconds": secs, "ticks_per_s": ticks / secs,
        "writes_per_s": writes / secs, "reads_per_s": reads / secs,
        "clean_read_fraction": clean / max(1, clean + dirty),
        "write_latency_p50_ticks": wp50, "write_latency_p99_ticks": wp99,
        "read_latency_p50_ticks": rp50, "read_latency_p99_ticks": rp99,
        "invariants": sim.invariants(), "launches": launches,
        "route_launches": routes,
    }
    log(json.dumps(line))
    return {"line": line, "sim": sim}


def bpaxos_run(ctx, cfg, warm: int, ticks: int, phase: str) -> dict:
    """Drive BPaxos through its entry points (as :func:`craq_run`). Raises
    unless the execute kernel ran once a tick, every invariant holds, and
    commands committed and executed."""
    registry, bb = ctx["registry"], ctx["bb"]
    sim = BatchedSim(bb, ctx["prng"], cfg, seed=0)
    if warm:
        sim.timed_run(warm)
    names = ("committed_total", "executed_total", "coexecuted", "retired_total")
    before = sim.get(*names)
    registry.reset_launches()
    secs = sim.timed_run(ticks)
    launches = only_launches(registry, DG_PLANE, ticks, phase)
    sim.assert_invariants(phase)
    d = dict(zip(names, (a - b for a, b in zip(sim.get(*names), before))))
    if d["committed_total"] <= 0 or d["executed_total"] <= 0:
        raise AssertionError(f"{phase}: no progress: {d}")
    p50, p99 = hist_percentiles(sim.state.lat_hist)
    R = cfg.num_replicas
    line = {
        "phase": phase, "card": ctx["card"], "leaders": cfg.num_leaders,
        "replicas": R, "vertices": cfg.num_vertices,
        "conflict_rate": cfg.conflict_rate, "ticks": ticks, "seconds": secs,
        "ticks_per_s": ticks / secs,
        "committed_per_s": d["committed_total"] / secs,
        "executed_per_replica_per_s": d["executed_total"] / R / secs,
        "coexecuted": d["coexecuted"], "retired": d["retired_total"],
        "execute_latency_p50_ticks": p50, "execute_latency_p99_ticks": p99,
        "invariants": sim.invariants(), "launches": launches,
    }
    log(json.dumps(line))
    return {"line": line, "sim": sim}


def bpaxos_plane_args(bb, cfg, state, t: int) -> tuple:
    """The execute plane's inputs as the BPaxos tick at ``t`` builds them
    from ``state`` (tick steps 1-2): the shared adjacency as a stride-0
    batch, and each replica's (committed, active) view."""
    W, R, V = cfg.window, cfg.num_replicas, cfg.num_vertices
    abs_now = bb._abs_slot(state.gc_head, W)
    com = state.proposed[None] & (state.rep_commit_tick <= t)
    act = state.proposed[None] & (abs_now[None] >= state.head_r[:, :, None])
    adj = state.adj.expand(R, V, state.adj.shape[1])
    return adj, com.reshape(R, V).contiguous(), act.reshape(R, V).contiguous()


def craq_and_bpaxos(ctx) -> dict:
    """Phases 33-41: CRAQ at 2,500 chains (100 warm-up, 300 timed ticks,
    profiled), at the snapshot's 256, at 25,000 and under a fault plan;
    BPaxos at 5 x 64 (profiled), in its dense corner, at 5 x 256 and under a
    fault plan; both card against CPU. Returns the main-path launches,
    tick times, the kernels' profiled device times, and the BPaxos states
    the execute kernel's timing rows take their inputs from."""
    cb, bb, prng, card = ctx["cb"], ctx["bb"], ctx["prng"], ctx["card"]
    registry, FaultPlan = ctx["registry"], ctx["FaultPlan"]
    out = {}
    # 33-35. CRAQ: the per-chain shape of scripts/batched_backends_snapshot.py
    # (chain_len 4, 64 keys, W=16, 2 writes and 4 reads a tick, read window
    # 32, latency 1-3) at 2,500 chains (10,000 chain nodes), 256 and 25,000.
    N, W, L, KV = CR_SHAPES[0]
    cr = cb.BatchedCraqConfig(
        num_chains=N, chain_len=L, num_keys=KV, window=W, writes_per_tick=2,
        reads_per_tick=4, read_window=32, lat_min=1, lat_max=3,
    )
    run = craq_run(ctx, cr, 100, 300, "craq")
    out[CR_PLANE] = run["line"]["launches"][CR_PLANE]
    out["cr_routes"] = run["line"]["route_launches"]
    out["cr_tick_ms"] = run["line"]["seconds"] * 1e3 / 300
    prof = profile_ticks(run["sim"].run, run["sim"].sync, 20, card, "craq_profile",
                         kernel="craq_chain")
    log(json.dumps(prof))
    out["cr_profiled_ms"] = prof["kernel_device_ms_per_launch"]
    del run
    small = craq_run(ctx, dataclasses.replace(cr, num_chains=256), 100, 300, "craq_256")
    out["cr_256_tick_ms"] = small["line"]["seconds"] * 1e3 / 300
    del small
    big = dataclasses.replace(cr, num_chains=CR_SHAPES[1][0])
    out["cr_100k_tick_ms"] = craq_run(ctx, big, 0, 50, "craq_100k")["line"]["seconds"] * 20
    torch.cuda.empty_cache()

    # 36. CRAQ under a static plan at 256 chains: drops and jitter on every
    # hop, middle-node crashes, node 2 cut from tick 20 to 60.
    plan = FaultPlan(
        drop_rate=0.05, jitter=1, crash_rate=0.01, revive_rate=0.2,
        partition=(0, 0, 1, 0), partition_start=20, partition_heal=60,
    )
    sim = BatchedSim(cb, prng, dataclasses.replace(cr, num_chains=256, faults=plan))
    registry.reset_launches()
    secs = sim.timed_run(60)
    (w_heal,) = sim.get("writes_done")
    secs += sim.timed_run(40)
    launches = only_launches(registry, CR_PLANE, 100, "craq faults")
    only_route(registry, CR_PLANE, 100, "craq faults")
    sim.assert_invariants("craq faults")
    s = sim.stats()
    if int(sim.state.crashes) <= 0 or s["writes_done"] <= w_heal:
        raise AssertionError(f"craq faults: crashes {int(sim.state.crashes)}, {s}")
    log(json.dumps({
        "phase": "craq_faults", "card": card, "ticks": 100, "seconds": secs,
        "ticks_per_s": 100 / secs, "writes_after_heal": s["writes_done"] - w_heal,
        "crashes": int(sim.state.crashes), "resyncs": int(sim.state.resyncs),
        "stats": s, "invariants": sim.invariants(), "launches": launches,
    }))
    del sim

    # 37-39. BPaxos: the 5-replica SimpleBPaxos of BASELINE.md (5 leaders, 5
    # replicas) over the depgraph microbench's window of 64 (V = 320, 10
    # words a row), 2 commands a tick, latency 1-3; conflict 1/4, then the
    # dense corner (conflict 1, SCCs form), then window 256 (V = 1280).
    bp = bb.BatchedBPaxosConfig(
        num_leaders=5, window=64, cmds_per_tick=2, num_replicas=5,
        conflict_rate=0.25, lat_min=1, lat_max=3,
    )
    run = bpaxos_run(ctx, bp, 100, 300, "bpaxos")
    out[DG_PLANE] = run["line"]["launches"][DG_PLANE]
    out["dg_tick_ms"] = run["line"]["seconds"] * 1e3 / 300
    prof = profile_ticks(run["sim"].run, run["sim"].sync, 20, card, "bpaxos_profile",
                         kernel="depgraph_kernel")
    log(json.dumps(prof))
    out["dg_profiled_ms"] = prof["kernel_device_ms_per_launch"]
    out["dg_state"] = (bp, run["sim"].state, run["sim"].t)
    del run
    dense = bpaxos_run(ctx, dataclasses.replace(bp, conflict_rate=1.0), 100, 300,
                       "bpaxos_dense")
    if dense["line"]["coexecuted"] <= 0:
        raise AssertionError(f"bpaxos dense: no SCC co-execution: {dense['line']}")
    out["dg_dense_tick_ms"] = dense["line"]["seconds"] * 1e3 / 300
    del dense
    wide = dataclasses.replace(bp, window=256)
    run = bpaxos_run(ctx, wide, 0, 50, "bpaxos_1280")
    out["dg_1280_tick_ms"] = run["line"]["seconds"] * 20
    # The kernel row's inputs: the state after the 50 ticks (a tick builds
    # a new State), as before this run was profiled.
    out["dg_1280_state"] = (wide, run["sim"].state, run["sim"].t)
    prof = profile_ticks(run["sim"].run, run["sim"].sync, 20, card, "bpaxos_1280_profile",
                         kernel="depgraph_kernel")
    log(json.dumps(prof))
    out["dg_1280_profiled_ms"] = prof["kernel_device_ms_per_launch"]
    del run

    # 40. BPaxos under a static plan: drops and jitter on the consensus
    # hops, leader lane 2 cut from tick 20 to 60.
    sim = BatchedSim(bb, prng, dataclasses.replace(bp, faults=FaultPlan(
        drop_rate=0.05, jitter=1, partition=(0, 0, 1, 0, 0), partition_start=20,
        partition_heal=60,
    )))
    registry.reset_launches()
    secs = sim.timed_run(60)
    at_heal = sim.get("committed_total", "executed_total")
    secs += sim.timed_run(40)
    after = sim.get("committed_total", "executed_total")
    launches = only_launches(registry, DG_PLANE, 100, "bpaxos faults")
    sim.assert_invariants("bpaxos faults")
    if not all(a > b for a, b in zip(after, at_heal)):
        raise AssertionError(f"bpaxos faults: {at_heal} -> {after}")
    log(json.dumps({
        "phase": "bpaxos_faults", "card": card, "ticks": 100, "seconds": secs,
        "ticks_per_s": 100 / secs, "committed_after_heal": after[0] - at_heal[0],
        "executed_after_heal": after[1] - at_heal[1],
        "invariants": sim.invariants(), "launches": launches,
    }))
    del sim
    torch.cuda.empty_cache()

    # 41. Card against CPU: the analysis configs under a plan of drop,
    # jitter and a healing cut (CRAQ also dup and chain-node crashes), seed
    # 0, 120 ticks.
    for name, mod, plan in (
        ("craq", cb, FaultPlan(drop_rate=0.1, dup_rate=0.1, jitter=1, crash_rate=0.05,
                               revive_rate=0.3, partition=(0, 1, 0),
                               partition_start=5, partition_heal=40)),
        ("bpaxos", bb, FaultPlan(drop_rate=0.1, jitter=1, partition=(0, 1, 0),
                                 partition_start=5, partition_heal=40)),
    ):
        n = cards_equal(mod, prng, mod.analysis_config(faults=plan), name)
        log(f"{name} card == cpu: {n} leaves equal after 120 ticks")
    return out


def craq_dg_kernel_rows(ctx, launches: dict, max_err: dict, cd: dict) -> list:
    """Kernel rows for #11 and #12: the kernel alone, the wrapper and the
    plain version, beside the least time the card could take. The chain
    kernel at its two main shapes (random inputs), bound by the bytes these
    inputs need (``ops/craq.py`` ``craq_chain_needed_bytes``; the
    all-bytes figure is ``bytes``), with :func:`vector_route_keys`. The
    execute kernel on the inputs of the BPaxos runs at V = 320 and 1280,
    bound by the operations these inputs need (:func:`dg_needed_ops`);
    beside it, under ``bound_ms_warshall``, the bound of the kernel's
    earlier rows (Warshall over all V rows and an O(V^2) rank). Beside the
    bounds, the shared bytes a CTA (0 on the global scratch) and the rounds
    of squaring the kernel counted in each graph on these inputs. Returns
    the rows and, for a line of its own, the schedule model's counts on the
    same inputs (:func:`dg_schedule_ops`)."""
    registry, cro, dgo, bb = ctx["registry"], ctx["cro"], ctx["dgo"], ctx["bb"]
    rows = []
    model = {"name": DG_PLANE, "what": "dg_schedule_ops: a host model, not measured"}
    row = {
        "name": CR_PLANE, "route": "cuda", "source": registry.PLANES[CR_PLANE].source,
        "replaces": registry.PLANES[CR_PLANE].replaces,
        "launches": launches[CR_PLANE], "launches_per_tick": 1, "exact": True,
        "max_abs_err": max_err[CR_PLANE], "device_ms_profiled": cd["cr_profiled_ms"],
    }
    for i, shape in enumerate(CR_SHAPES):
        N, W, L, KV = shape
        st = craq_statics(L, KV)
        args = registry.to_torch(
            cro.example_craq_chain_args(np.random.default_rng(7), *shape), "cuda"
        )
        launch, outs = cro.prepared_launch(*args, **st)
        moved = nbytes(args) + nbytes(outs)
        needed = cro.craq_chain_needed_bytes(args, **st)
        ops = N * W * 40
        timed = _timed_vote_row(
            cro.fused_craq_chain, cro.reference_craq_chain, launch, args, st,
            needed, moved, ops,
        )
        timed.update(vector_route_keys("craq", args, st, launch, needed, moved))
        key = "" if i == 0 else "_100k"
        row.update({f"{k}{key}": v for k, v in timed.items()})
        row["shape" + key] = list(shape)
    row["route_launches"] = cd["cr_routes"]
    row["library_ms"] = None
    rows.append(row)

    row = {
        "name": DG_PLANE, "route": "cuda", "source": registry.PLANES[DG_PLANE].source,
        "replaces": registry.PLANES[DG_PLANE].replaces,
        "launches": launches[DG_PLANE], "launches_per_tick": 1, "exact": True,
        "max_abs_err": max_err[DG_PLANE], "device_ms_profiled": cd["dg_profiled_ms"],
        "device_ms_profiled_1280": cd["dg_1280_profiled_ms"],
    }
    for i, which in enumerate(("dg_state", "dg_1280_state")):
        cfg, state, t = cd[which]
        args = bpaxos_plane_args(bb, cfg, state, t)
        adj, com, act = args
        B, V, VW = adj.shape
        launch, outs = dgo.prepared_launch(*args)
        n_active = int(act.sum())
        ops = dg_needed_ops(dgo, *args)
        warshall = n_active * V * VW * 3 + B * (V * VW * 4 + V * V * 4)
        moved = V * VW * 4 + nbytes((com, act)) + nbytes(outs)
        timed = _timed_vote_row(
            dgo.fused_depgraph_execute, dgo.reference_depgraph_execute, launch,
            args, {}, moved, moved, ops,
        )
        timed["bound_ops"] = ops
        timed["bound_ms_warshall"] = max(
            moved / HBM_BYTES_PER_S * 1e3, warshall / INT32_OPS_PER_S * 1e3
        )
        timed["bound_ops_warshall"] = warshall
        timed["active_vertices"] = n_active
        nbytes_ws, shared = dgo.working_set(V)
        timed["working_set"] = "shared" if shared else "scratch"
        timed["shared_bytes_per_cta"] = nbytes_ws if shared else 0
        torch.cuda.synchronize()
        timed["rounds_per_graph"] = launch.rounds.tolist()
        key = "" if i == 0 else "_1280"
        row.update({f"{k}{key}": v for k, v in timed.items()})
        row["shape" + key] = [B, V, VW]
        word_ops, rounds = dg_schedule_ops(dgo, *args)
        model.update({f"word_ops{key}": word_ops, f"lockstep_rounds{key}": rounds})
    row["library_ms"] = None
    rows.append(row)
    return rows, model


def dg_needed_ops(dgo, adj, committed, active) -> int:
    """The word operations the execute plane needs on these inputs, graph
    by graph, over the n active vertices and their naw active words: the
    seed (n naw), the closure as a sequential walk would build it, each
    active row ORing in a direct successor's finished row once per active
    edge (E naw; reverse topological order of the condensation), the root,
    size and eligibility passes (3 n naw), and a sort of the ne eligible
    vertices by (size, id) (ne ceil(log2 ne))."""
    B, V, VW = adj.shape
    pad = VW * 32 - V
    act = torch.nn.functional.pad(active, (0, pad))
    naw = act.view(B, VW, 32).any(-1).sum(-1)
    n = active.sum(-1)
    off_diag = ~torch.eye(V, dtype=torch.bool, device=adj.device)
    A = dgo.unpack_mask(adj, VW * 32)[:, :V, :V] & active[:, None, :] & active[:, :, None]
    E = (A & off_diag).sum((-1, -2))
    ne = dgo.reference_depgraph_execute(adj, committed, active)[0].sum(-1)
    sort = ne * torch.ceil(torch.log2(ne.clamp(min=1).double())).long()
    return int(((4 * n + E) * naw + sort).sum())


def dg_schedule_ops(dgo, adj, committed, active) -> tuple:
    """A host model of the execute kernel's schedule, not a measurement:
    its word operations on these inputs and its most rounds in a graph,
    counted with the rounds run in lockstep (each round reads the rows as
    they stood at its start; the kernel, in place, may take fewer or more,
    and counts its own in ``launch.rounds``): the seed (a word per active row and active
    word), each round's pairs whose word is not yet full (a read per
    active word and a load per set bit that the row pulls: all of them in
    the first round and for a row written in the round before, else those
    of the rows written in the round before; full ones stop at once), the
    root and per-row passes (two per active row and active word, and at
    most a test per set bit at or below the row's own id) and the rank
    (eligible squared)."""
    B, V, VW = adj.shape
    pad = VW * 32 - V
    act = torch.nn.functional.pad(active, (0, pad))  # [B, VW*32]
    A = dgo.unpack_mask(adj, VW * 32)[:, :V, :] & act[:, None, :] & active[:, :, None]
    eye = torch.eye(V, VW * 32, dtype=torch.bool, device=adj.device)
    R = A | (eye[None] & active[:, :, None])  # [B, V, VW*32]
    act_words = act.view(B, 1, VW, 32)
    aw = act_words.any(-1)  # [B, 1, VW]
    naw = aw.sum(-1)  # [B, 1]
    n = active.sum(-1)
    ops = int((n * naw[:, 0]).sum())
    rounds = torch.zeros(B, dtype=torch.int64, device=adj.device)
    live = n > 0
    dirty = active.clone()  # [B, V]: rows written in the round before
    while bool(live.any()):
        full = (R.view(B, V, VW, 32) == act_words).all(-1)  # [B, V, VW]
        pairs = aw & ~full & active[:, :, None]
        pulled = torch.where(dirty[:, :, None], R[..., :V], R[..., :V] & dirty[:, None, :])
        per_row = naw + pulled.sum(-1)  # [B, V]
        ops += int((pairs.sum(-1) * per_row * live[:, None]).sum())
        rounds += live
        Rf = R[..., :V].float()
        step = R | (torch.bmm(Rf, R.float()) > 0)
        dirty = (step != R).any(-1)
        live = live & dirty.any(-1)
        R = step
    elig = dgo.reference_depgraph_execute(adj, committed, active)[0]
    ids = torch.arange(VW * 32, device=adj.device)
    walked = (R[:, :, :V] & (ids[None, None, :V] <= ids[None, :V, None])).sum(-1)
    ops += int((2 * n * naw[:, 0]).sum()) + int((walked * active).sum())
    ops += int((elig.sum(-1) ** 2).sum())
    return ops, int(rounds.max())


# -- The six-pass grid vote (#6) and the port's microbench -------------------

UF_PLANE = "compartmentalized_unfused_grid_vote"
# (shape, misaligned, routes label) at which the six-pass kernel is held
# against its plain passes and the fused kernel: the main shape, two
# ragged shapes and W > 1024 (the replica pass general) on the routes
# they take, and the shapes that take the others: misaligned copies and
# G * W % 8 != 0 (every pass scalar), W % 8 != 0 with G * W % 8 == 0
# (flat passes vector, replica scalar), the replica pass without a
# whole-warp shuffle (W / 8 = 3), five and six replicas (two trips of
# rows), nine grid cells.
UF_ROUTE_CASES = (
    (CZ_MAIN, False, "vector"),
    ((2, 3, 2, 7, 16), False, "vector"),
    ((3, 2, 3, 64, 64), False, "vector"),
    ((2, 2, 3, 512, 2048), False, "vector+general"),
    (CZ_MAIN, True, "scalar"),
    ((2, 2, 3, 512, 2048), True, "scalar+general"),
    ((2, 3, 2, 7, 12), False, "scalar"),
    ((2, 2, 3, 2000, 12), False, "vector+scalar"),
    ((2, 2, 5, 9, 24), False, "vector"),
    ((3, 3, 6, 17, 40), False, "vector"),
    ((1, 4, 4, 70, 8), False, "vector"),
    ((2, 2, 3, 33, 1024), False, "vector"),
)
# The six kernels of one call, by name in the profiler, mangled or not
# (the replica pass is uf_replica_any for W > 1024).
UF_KERNEL_RE = r"uf_(age|vote|counts|choose|replica|retry)"


def grid_vote_needed(czo, args, st) -> tuple:
    """The bytes the grid vote's inputs need: ``(fused, passes)``, the
    fused kernel's (``ops/compartmentalized.py`` ``grid_vote_needed_bytes``)
    and each of the six passes' (``unfused_needed_bytes``, by pass
    name)."""
    fused = czo.grid_vote_needed_bytes(args, czo.reference_grid_vote(*args, **st))
    return fused, czo.unfused_needed_bytes(*args, **st)


def check_unfused(ctx) -> int:
    """Hold the six-pass kernel against its plain passes, pass by pass and
    composed, and its ten outputs against the fused kernel's, at
    UF_ROUTE_CASES, with a tolerance of zero; each case must take the
    routes it names, counted by the wrapper. Returns the largest
    difference (0)."""
    registry, czo = ctx["registry"], ctx["czo"]
    st = dict(retry_timeout=16)
    worst = 0
    for shape, skew, routes in UF_ROUTE_CASES:
        rng = np.random.default_rng(sum(shape))
        args = registry.to_torch(czo.example_grid_vote_args(rng, *shape), "cuda")
        if skew:
            args = registry.misaligned(args)
        label = f"{UF_PLANE}{shape}{' misaligned' if skew else ''}"
        launch, _, passes = czo.prepared_unfused_launch(*args, **st)
        registry.reset_launches()
        launch()
        torch.cuda.synchronize()
        took = registry.ROUTE_LAUNCHES.get(UF_PLANE, {})
        if took != {routes: 1}:
            raise AssertionError(f"{label}: routes {took}, want {routes}")
        plain = czo.reference_unfused_passes(*args, **st)
        for name in czo.UNFUSED_PASSES:
            worst = max(worst, outputs_equal(
                f"{label} {name} pass", plain[name], passes[name]
            ))
        got = czo.unfused_grid_vote(*args, **st)
        torch.cuda.synchronize()
        want = czo.reference_unfused_grid_vote(*args, **st)
        worst = max(worst, outputs_equal(label, want, got))
        fused = czo.fused_grid_vote(*args, **st)
        torch.cuda.synchronize()
        worst = max(worst, outputs_equal(f"{label} vs fused", fused, got))
        log(f"exact: {label} ({routes}): each pass, the composition, the fused kernel")
    return worst


def time_unfused(ctx) -> dict:
    """#6 at the Compartmentalized main shape: CUDA-event median of 30
    calls, the profiler's device time of one call (which must be six
    kernel launches, one of each pass), the plain passes' time, and the
    fused kernel's on the same inputs; each pass alone (``passes``: cold,
    clean and warm, its bound and a cold copy of its bytes) and the six
    scalar kernels' cold time. Its bound is the bytes each pass needs on
    these inputs (grid_vote_needed), summed over the six passes;
    ``bytes`` is every byte each pass reads and writes."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    registry, czo = ctx["registry"], ctx["czo"]
    R, C, NR, G, W = CZ_MAIN
    args = registry.to_torch(
        czo.example_grid_vote_args(np.random.default_rng(7), *CZ_MAIN), "cuda"
    )
    st = dict(retry_timeout=16)
    launch, outs, passes = czo.prepared_unfused_launch(*args, **st)
    fused_launch, fused_outs = czo.prepared_launch(*args, **st)
    slot = dict(zip(czo.GRID_VOTE_IN_SLOTS, args))
    for name, (_, written) in czo.UNFUSED_PASS_IO.items():
        slot.update(zip(written, passes[name]))
    pass_bytes = {
        name: nbytes([slot[k] for k in reads + written])
        for name, (reads, written) in czo.UNFUSED_PASS_IO.items()
    }
    moved = sum(pass_bytes.values())
    fused_needed, pass_needed = grid_vote_needed(czo, args, st)
    needed = sum(pass_needed.values())
    # int32 operations per grid cell, replica cell and slot over the six
    # passes, counted from the kernel source.
    cells, rep_cells = R * C * G * W, NR * G * W
    ops = cells * 22 + rep_cells * 12 + G * W * 25
    bytes_ms = needed / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3

    # A warm-up step first: the profiler misses the kernels launched just
    # after it starts tracing, so only the second step's are counted.
    calls = 20
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
    ) as prof:
        for _ in range(2):
            for _ in range(calls):
                launch()
            torch.cuda.synchronize()
            prof.step()
    per_pass, device_us = {}, 0.0
    for e in prof.key_averages():
        m = re.search(UF_KERNEL_RE, e.key)
        if m and e.device_type == DeviceType.CUDA:
            per_pass[m.group(1)] = per_pass.get(m.group(1), 0) + e.count
            device_us += float(getattr(e, "self_device_time_total", 0.0) or 0.0)
    if len(per_pass) != 6 or any(n != calls for n in per_pass.values()):
        raise AssertionError(f"{UF_PLANE}: kernel launches in {calls} calls: {per_pass}")

    fused_ms = time_ms(fused_launch)
    ms = time_ms(launch)
    fused_ms_again = time_ms(fused_launch)
    # Each pass alone, cold, clean and warm, on the inputs the earlier
    # passes left in the outputs (a pass writes nothing it reads), beside
    # the least time for the bytes it needs and a cold copy of them; and
    # the six kernels as first written (every pass scalar) on the same
    # pointers.
    from frankenpaxos_tpu_torch.harness import chain_race as race

    launch()
    per_pass = {}
    for name in czo.UNFUSED_PASSES:
        per_pass[name] = {
            **device_times(launch.passes[name]),
            "bound_ms": pass_needed[name] / HBM_BYTES_PER_S * 1e3,
            **yardstick_keys(pass_needed[name]),
        }
    scalar = race.launcher("czu", None, race.czu_scalar_edit(W), launch.packed)
    return {
        "name": UF_PLANE,
        "route": "cuda",
        "source": "frankenpaxos_tpu_torch/csrc/compartmentalized.cu",
        "replaces": czo.UNFUSED_REPLACES,
        "kernels_per_launch": 6,
        "exact": True,
        "ms": ms,
        **device_times(launch),
        "device_ms": device_us / 1e3 / calls,
        "wrapper_ms": time_ms(lambda: czo.unfused_grid_vote(*args, **st)),
        "plain_ms": time_ms(
            lambda: czo.reference_unfused_grid_vote(*args, **st), reps=10
        ),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": moved,
        "bound_bytes": needed,
        "pass_bytes": pass_bytes,
        "pass_bound_bytes": pass_needed,
        "fused_bytes": nbytes(args) + nbytes(fused_outs),
        "fused_bound_bytes": fused_needed,
        "fused_ms": [fused_ms, fused_ms_again],
        "fused_device_ms_cold": device_times(fused_launch)["device_ms_cold"],
        "routes": launch.routes,
        "passes": per_pass,
        "scalar_device_ms_cold": device_times(scalar)["device_ms_cold"],
        **yardstick_keys(needed),
        "library_ms": None,
    }


# -- the routes of the phase-1 (#4) and grid-vote (#5) kernels --------------

P1_PLANE = "multipaxos_p1_promise"
CZ_PLANE = "compartmentalized_grid_vote"
# (shape, case, misaligned, route): the vector route at the main shape on
# every input case and at the repaired shapes (A = 11, W = 2048), the
# general kernel (a thread a slot) on misaligned copies and at W % 8 != 0.
P1_ROUTE_CASES = (
    (FLAGSHIP, "random", False, "vector"),
    (FLAGSHIP, "sparse", False, "vector"),
    (FLAGSHIP, "noop", False, "vector"),
    (FLAGSHIP, "ties", False, "vector"),
    ((5, 64, 64), "random", False, "vector"),
    ((11, 3334, 256), "random", False, "vector"),
    ((3, 512, 2048), "random", False, "vector"),
    (FLAGSHIP, "random", True, "general"),
    (FLAGSHIP, "sparse", True, "general"),
    ((3, 7, 12), "random", False, "general"),
    ((3, 3334, 12), "ties", False, "general"),
    ((11, 3334, 256), "random", True, "general"),
    ((3, 512, 2048), "random", True, "general"),
)
CZ_ROUTE_CASES = (
    (CZ_MAIN, False, "vector"),
    ((2, 2, 3, 7, 16), False, "vector"),
    ((1, 4, 4, 64, 64), False, "vector"),
    ((2, 2, 3, 1000, 8), False, "vector"),
    ((2, 2, 2, 700, 24), False, "vector"),
    ((2, 2, 3, 700, 256), False, "vector"),
    ((2, 2, 3, 300, 1024), False, "vector"),
    (CZ_MAIN, True, "scalar"),
    ((2, 2, 3, 2000, 12), False, "scalar"),
    ((2, 3, 2, 7, 16), False, "scalar"),
    ((3, 2, 5, 64, 64), False, "scalar"),
    ((2, 2, 3, 512, 2048), False, "general"),
    ((2, 3, 2, 7, 1030), False, "general"),
)


def check_routes(ctx) -> dict:
    """Hold #4 and #5 against their plain versions, with a tolerance of
    zero, on every route (P1_ROUTE_CASES, CZ_ROUTE_CASES): each case must
    take the route it names, counted by the wrapper. Returns the largest
    difference per plane (0)."""
    registry, mp, czo = ctx["registry"], ctx["mp"], ctx["czo"]
    err = {P1_PLANE: 0, CZ_PLANE: 0}
    for shape, case, skew, route in P1_ROUTE_CASES:
        rng = np.random.default_rng(sum(shape))
        args = mp.to_torch(mp.example_p1_promise_args(rng, *shape, case=case), "cuda")
        if skew:
            args = registry.misaligned(args)
        registry.reset_launches()
        got = mp.fused_p1_promise(*args)
        torch.cuda.synchronize()
        took = registry.ROUTE_LAUNCHES.get(P1_PLANE, {})
        label = f"{P1_PLANE}{shape} {case}{' misaligned' if skew else ''}"
        if took != {route: 1}:
            raise AssertionError(f"{label}: routes {took}, want {route}")
        want = mp.reference_p1_promise(*args)
        err[P1_PLANE] = max(err[P1_PLANE], outputs_equal(label, want, got))
        log(f"exact: {label} ({route})")
    st = dict(retry_timeout=16)
    for shape, skew, route in CZ_ROUTE_CASES:
        rng = np.random.default_rng(sum(shape))
        args = registry.to_torch(czo.example_grid_vote_args(rng, *shape), "cuda")
        if skew:
            args = registry.misaligned(args)
        registry.reset_launches()
        got = czo.fused_grid_vote(*args, **st)
        torch.cuda.synchronize()
        took = registry.ROUTE_LAUNCHES.get(CZ_PLANE, {})
        label = f"{CZ_PLANE}{shape}{' misaligned' if skew else ''}"
        if took != {route: 1}:
            raise AssertionError(f"{label}: routes {took}, want {route}")
        want = czo.reference_grid_vote(*args, **st)
        err[CZ_PLANE] = max(err[CZ_PLANE], outputs_equal(label, want, got))
        log(f"exact: {label} ({route})")
    return err


def run_microbench(ctx) -> dict:
    """The port's microbench on the card at its default (flagship) sizes,
    with few iterations: its JSON lines are printed as it runs. Raises on
    a kernel whose outputs differ from its plain version's and on a race
    whose sides differ. Returns the launch counts of the run and the
    summaries."""
    from frankenpaxos_tpu_torch.harness import microbench as mbh

    registry = ctx["registry"]
    registry.reset_launches()
    t0 = time.perf_counter()
    kernels = mbh.bench_kernels(iters=5)[-1]
    races = {
        "fused_tick": mbh.bench_fused_tick(iters=10, rounds=3)[-1],
        "grid_vote": mbh.bench_grid_vote(iters=20, rounds=5)[-1],
        "depgraph": mbh.bench_depgraph(rounds=2)[-1],
    }
    secs = time.perf_counter() - t0
    launches = dict(registry.LAUNCHES)
    bad = [n for n, e in kernels["planes"].items() if e["parity"] is not True]
    bad += [n for n, r in races.items() if r["bit_identical"] is not True]
    if bad:
        raise AssertionError(f"microbench: outputs differ in {bad}")
    # One parity call and 20 x 5 timed calls of the grid-vote race.
    if launches[UF_PLANE] != 101 or any(
        launches[name] <= 0 for name in registry.PLANES
    ):
        raise AssertionError(f"microbench launches: {launches}")
    log(json.dumps({
        "phase": "microbench", "card": ctx["card"], "seconds": secs,
        "launches": launches,
    }))
    return {"launches": launches, "kernels": kernels, **races}



def main() -> int:
    # -- 1. the card ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    from frankenpaxos_tpu_torch import prng
    from frankenpaxos_tpu_torch.ops import _build, registry
    from frankenpaxos_tpu_torch.ops import compartmentalized as czo
    from frankenpaxos_tpu_torch.ops import craq as cro
    from frankenpaxos_tpu_torch.ops import depgraph as dgo
    from frankenpaxos_tpu_torch.ops import fastmultipaxos as fmo
    from frankenpaxos_tpu_torch.ops import horizontal as hzo
    from frankenpaxos_tpu_torch.ops import mencius as meo
    from frankenpaxos_tpu_torch.ops import multipaxos as mp
    from frankenpaxos_tpu_torch.ops import scalog as sco
    from frankenpaxos_tpu_torch.ops.registry import KernelPolicy
    from frankenpaxos_tpu_torch.tpu import bpaxos_batched as bb
    from frankenpaxos_tpu_torch.tpu import compartmentalized_batched as czb
    from frankenpaxos_tpu_torch.tpu import craq_batched as cb
    from frankenpaxos_tpu_torch.tpu import fastmultipaxos_batched as fb
    from frankenpaxos_tpu_torch.tpu import horizontal_batched as hb
    from frankenpaxos_tpu_torch.tpu import mencius_batched as mb
    from frankenpaxos_tpu_torch.tpu import multipaxos_batched as mpb
    from frankenpaxos_tpu_torch.tpu import scalog_batched as sb
    from frankenpaxos_tpu_torch.tpu import telemetry as telemetry_mod
    from frankenpaxos_tpu_torch.tpu.faults import FaultPlan
    from frankenpaxos_tpu_torch.tpu.transport import TpuSimTransport

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s (set-up; nvcc "
        f"{_build.BUILD_SECONDS:.2f} s)")
    log(_build.BUILD_LOG.strip()[-3000:])

    # -- 3. kernel against plain version -------------------------------------
    kernels = {
        "vote": (mp.fused_vote_quorum, mp.reference_vote_quorum,
                 "multipaxos_vote_quorum"),
        "dispatch": (mp.fused_mp_dispatch, mp.reference_mp_dispatch,
                     "multipaxos_dispatch"),
        "tick": (mp.fused_tick, mp.reference_fused_tick,
                 "multipaxos_fused_tick"),
        "p1": (mp.fused_p1_promise, mp.reference_p1_promise,
               "multipaxos_p1_promise"),
    }
    max_err = {plane: 0 for _, _, plane in kernels.values()}
    for shape in (FLAGSHIP, (3, 7, 16), (5, 64, 64)):
        for which, (kern, plain, plane) in kernels.items():
            for age in ((True, False) if which == "tick" else (True,)):
                args, st = plane_args(mp, which, shape, seed=sum(shape), age=age)
                got = kern(*args, **st)
                torch.cuda.synchronize()
                want = plain(*args, **st)
                torch.cuda.synchronize()
                label = f"{plane}{shape}" + (f" age={age}" if which == "tick" else "")
                max_err[plane] = max(max_err[plane], outputs_equal(label, want, got))
                log(f"exact: {label}")
    # The phase-1 kernel's edge inputs: every slot repairs to a noop, and
    # vote-round ties with different values (the first learned wins).
    p1_plane = "multipaxos_p1_promise"
    for case in ("noop", "ties"):
        for shape in (FLAGSHIP, (3, 7, 16)):
            rng = np.random.default_rng(sum(shape))
            args = mp.to_torch(mp.example_p1_promise_args(rng, *shape, case=case), "cuda")
            got = mp.fused_p1_promise(*args)
            torch.cuda.synchronize()
            want = mp.reference_p1_promise(*args)
            label = f"{p1_plane}{shape} {case}"
            max_err[p1_plane] = max(max_err[p1_plane], outputs_equal(label, want, got))
            log(f"exact: {label}")
    cz_plane = "compartmentalized_grid_vote"
    max_err[cz_plane] = 0
    for shape in (CZ_MAIN, (2, 3, 2, 7, 16), (3, 2, 3, 64, 64)):
        rng = np.random.default_rng(sum(shape))
        args = registry.to_torch(czo.example_grid_vote_args(rng, *shape), "cuda")
        got = czo.fused_grid_vote(*args, retry_timeout=16)
        torch.cuda.synchronize()
        want = czo.reference_grid_vote(*args, retry_timeout=16)
        torch.cuda.synchronize()
        label = f"{cz_plane}{shape}"
        max_err[cz_plane] = max(max_err[cz_plane], outputs_equal(label, want, got))
        log(f"exact: {label}")
    max_err.update(check_vote_kernels(registry, meo, fmo))
    max_err.update(check_hz_sc_kernels(registry, hzo, sco))
    for plane, e in check_routes(dict(registry=registry, mp=mp, czo=czo)).items():
        max_err[plane] = max(max_err[plane], e)
    ctx = dict(
        card=card, prng=prng, registry=registry, telemetry=telemetry_mod,
        FaultPlan=FaultPlan, mb=mb, fb=fb, meo=meo, fmo=fmo, hb=hb, sb=sb,
        hzo=hzo, sco=sco, mp=mp, czo=czo, mpb=mpb,
        TpuSimTransport=TpuSimTransport, cro=cro, dgo=dgo, cb=cb, bb=bb,
    )
    max_err.update(check_craq_dg_kernels(ctx))
    # -- 32. the repaired shapes ---------------------------------------------
    repaired_err, repaired_timing = check_repaired_shapes(ctx)
    for plane, e in repaired_err.items():
        max_err[plane] = max(max_err[plane], e)

    # -- 4. main path at the flagship ----------------------------------------
    A, G, W = FLAGSHIP
    flagship = mpb.BatchedMultiPaxosConfig(
        f=1, num_groups=G, window=W, slots_per_tick=32, lat_min=1,
        lat_max=3, drop_rate=0.0, thrifty=True, retry_timeout=16,
    )
    tr = TpuSimTransport(flagship, seed=0)
    run_checked(tr, 100)
    c0 = tr.committed()
    registry.reset_launches()
    secs = run_checked(tr, 300)
    launches = dict(registry.LAUNCHES)
    if launches["multipaxos_fused_tick"] != 300 or launches[
        "multipaxos_vote_quorum"
    ] or launches["multipaxos_dispatch"]:
        raise AssertionError(f"flagship launches: {launches}")
    assert_invariants(tr, "flagship")
    stats = tr.stats()
    committed = tr.committed() - c0
    if committed <= 0:
        raise AssertionError("flagship run committed nothing")
    main_launches = {"multipaxos_fused_tick": launches["multipaxos_fused_tick"]}
    tick_ms = secs * 1e3 / 300
    flagship_line = {
        "phase": "flagship", "card": card, "acceptors": flagship.num_acceptors,
        "ticks": 300, "seconds": secs, "ticks_per_s": 300 / secs,
        "committed_per_s": committed / secs, "committed": committed,
        "commit_latency_p50_ticks": stats["commit_latency_p50_ticks"],
        "commit_latency_p99_ticks": stats["commit_latency_p99_ticks"],
        "launches": launches,
    }
    log(json.dumps(flagship_line))
    log(json.dumps(profile_ticks(
        tr.run, tr.block_until_ready, 20, card, "profile"
    )))
    del tr
    torch.cuda.empty_cache()

    # -- 5. the 100k-acceptor point ------------------------------------------
    big = mpb.BatchedMultiPaxosConfig(
        f=1, num_groups=33334, window=256, slots_per_tick=32,
        retry_timeout=16,
    )
    tr = TpuSimTransport(big, seed=0)
    registry.reset_launches()
    secs = run_checked(tr, 50)
    launches = dict(registry.LAUNCHES)
    if launches["multipaxos_fused_tick"] != 50:
        raise AssertionError(f"100k launches: {launches}")
    assert_invariants(tr, "100k")
    if tr.committed() <= 0:
        raise AssertionError("100k run committed nothing")
    log(json.dumps({
        "phase": "100k", "card": card, "acceptors": big.num_acceptors,
        "ticks": 50, "seconds": secs, "ticks_per_s": 50 / secs,
        "committed_per_s": tr.committed() / secs,
        "committed": tr.committed(), "launches": launches,
    }))
    del tr
    torch.cuda.empty_cache()

    # -- 6. the per-plane route, with drops ----------------------------------
    per_plane = mpb.BatchedMultiPaxosConfig(
        f=1, num_groups=G, window=W, slots_per_tick=32, drop_rate=0.05,
        retry_timeout=16,
        kernels=KernelPolicy(disable=("multipaxos_fused_tick",)),
    )
    tr = TpuSimTransport(per_plane, seed=0)
    registry.reset_launches()
    secs = run_checked(tr, 100)
    launches = dict(registry.LAUNCHES)
    if (launches["multipaxos_vote_quorum"], launches["multipaxos_dispatch"],
            launches["multipaxos_fused_tick"]) != (100, 100, 0):
        raise AssertionError(f"per-plane launches: {launches}")
    assert_invariants(tr, "per-plane")
    if tr.committed() <= 0:
        raise AssertionError("per-plane run committed nothing")
    main_launches["multipaxos_vote_quorum"] = launches["multipaxos_vote_quorum"]
    main_launches["multipaxos_dispatch"] = launches["multipaxos_dispatch"]
    log(json.dumps({
        "phase": "per_plane_drops", "card": card, "ticks": 100,
        "seconds": secs, "ticks_per_s": 100 / secs,
        "committed": tr.committed(), "launches": launches,
        "telemetry": tr.telemetry_summary()["drops_total"],
    }))
    del tr
    torch.cuda.empty_cache()

    # -- 7. card against CPU ---------------------------------------------------
    small = mpb.BatchedMultiPaxosConfig(
        f=1, num_groups=4, window=16, slots_per_tick=2, lat_min=1,
        lat_max=3, drop_rate=0.05, retry_timeout=8,
    )
    on_card = TpuSimTransport(small, seed=0)
    on_cpu = TpuSimTransport(small, seed=0, device="cpu")
    on_card.run(120)
    on_cpu.run(120)
    a, b = mpb.state_to_numpy(on_card.state), mpb.state_to_numpy(on_cpu.state)
    bad = [k for k in a if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
    if bad or on_card.stats() != on_cpu.stats():
        raise AssertionError(f"card vs CPU: leaves differ: {bad}")
    log(f"card == cpu: {len(a)} leaves equal after 120 ticks, "
        f"committed {on_card.committed()}")

    # -- 8. the Compartmentalized main path -----------------------------------
    R, C, NR, G_cz, W_cz = CZ_MAIN
    cz_main = czb.BatchedCompartmentalizedConfig(
        num_groups=G_cz, grid_rows=R, grid_cols=C, num_proxy_leaders=8,
        num_batchers=2, num_unbatchers=2, num_replicas=NR, window=W_cz,
        batch_size=8, arrivals_per_tick=4, lat_min=1, lat_max=3,
        retry_timeout=16,
    )
    sim = BatchedSim(czb, prng, cz_main, seed=0)
    sim.timed_run(100)
    c0, w0 = int(sim.state.committed), int(sim.state.writes_done)
    registry.reset_launches()
    secs = sim.timed_run(300)
    launches = only_launches(registry, cz_plane, 300, "compartmentalized")
    cz_routes = only_route(registry, cz_plane, 300, "compartmentalized")
    sim.assert_invariants("compartmentalized")
    committed = int(sim.state.committed) - c0
    writes = int(sim.state.writes_done) - w0
    if committed <= 0 or writes <= 0:
        raise AssertionError(
            f"compartmentalized run made no progress: committed {committed}, "
            f"writes_done {writes}"
        )
    main_launches[cz_plane] = launches[cz_plane]
    cz_stats = sim.stats()
    cz_tick_ms = secs * 1e3 / 300
    log(json.dumps({
        "phase": "compartmentalized", "card": card,
        "acceptors": cz_main.num_acceptors, "ticks": 300, "seconds": secs,
        "ticks_per_s": 300 / secs, "committed_entries_per_s": committed / secs,
        "committed_entries": committed, "writes_done_per_s": writes / secs,
        "commit_latency_p50_ticks": cz_stats["commit_latency_p50_ticks"],
        "latency_mean_ticks": cz_stats["latency_mean_ticks"],
        "launches": launches,
    }))
    log(json.dumps(profile_ticks(
        sim.run, sim.sync, 20, card, "cz_profile", kernel="grid_vote"
    )))
    del sim
    torch.cuda.empty_cache()

    # -- 9. the same shape with reads and faults ------------------------------
    cz_faulty = dataclasses.replace(
        cz_main, read_rate=2, read_window=6,
        faults=FaultPlan(drop_rate=0.05, jitter=1, crash_rate=0.02,
                         revive_rate=0.2),
    )
    sim = BatchedSim(czb, prng, cz_faulty, seed=1)
    registry.reset_launches()
    secs = sim.timed_run(100)
    launches = dict(registry.LAUNCHES)
    if launches[cz_plane] != 100:
        raise AssertionError(f"compartmentalized faults launches: {launches}")
    only_route(registry, cz_plane, 100, "compartmentalized faults+reads")
    sim.assert_invariants("compartmentalized faults+reads")
    tel = telemetry_mod.summary(sim.state.telemetry)
    reads = int(sim.state.reads_done)
    if tel["retries_total"] <= 0 or tel["drops_total"] <= 0 or reads <= 0:
        raise AssertionError(
            f"faults+reads: retries {tel['retries_total']}, drops "
            f"{tel['drops_total']}, reads {reads}"
        )
    log(json.dumps({
        "phase": "compartmentalized_faults_reads", "card": card, "ticks": 100,
        "seconds": secs, "ticks_per_s": 100 / secs,
        "committed_entries": int(sim.state.committed),
        "retries": tel["retries_total"], "drops": tel["drops_total"],
        "reads_done": reads, "proxies_down": int((~sim.state.proxy_alive).sum()),
        "launches": launches,
    }))
    del sim
    torch.cuda.empty_cache()

    # -- 10. Compartmentalized card against CPU -------------------------------
    small = czb.analysis_config(faults=FaultPlan(
        drop_rate=0.1, jitter=1, crash_rate=0.02, revive_rate=0.2,
        partition=(0, 0, 0, 1), partition_start=5, partition_heal=25,
    ))
    on_card = BatchedSim(czb, prng, small, seed=0)
    on_cpu = BatchedSim(czb, prng, small, seed=0, device="cpu")
    on_card.run(120)
    on_cpu.run(120)
    a = czb.state_to_numpy(on_card.state)
    b = czb.state_to_numpy(on_cpu.state)
    bad = [k for k in a if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
    if bad or on_card.stats() != on_cpu.stats():
        raise AssertionError(f"compartmentalized card vs CPU: leaves differ: {bad}")
    log(f"compartmentalized card == cpu: {len(a)} leaves equal after 120 "
        f"ticks, committed {int(on_card.state.committed)}, reads "
        f"{int(on_card.state.reads_done)}")

    # -- 11. MultiPaxos under failure at the flagship shape --------------------
    failover = dataclasses.replace(
        flagship, fail_rate=0.005, revive_rate=0.2, heartbeat_timeout=5,
        reconfigure_every=100,
    )
    tr = TpuSimTransport(failover, seed=0)
    run_checked(tr, 100)
    c0 = tr.committed()
    s0 = tr.stats()
    registry.reset_launches()
    secs = run_checked(tr, 300)
    launches = dict(registry.LAUNCHES)
    want = {"multipaxos_fused_tick": 300, "multipaxos_p1_promise": 600}
    if {k: launches[k] for k in want} != want or any(
        n for k, n in launches.items() if k not in want
    ):
        raise AssertionError(f"failover launches: {launches}")
    p1_routes = only_route(registry, p1_plane, 600, "failover")
    assert_invariants(tr, "failover")
    stats = tr.stats()
    committed = tr.committed() - c0
    if committed <= 0:
        raise AssertionError("failover run committed nothing")
    for key in ("elections", "reconfigurations", "old_configs_gcd"):
        if stats[key] <= 0:
            raise AssertionError(f"failover run: {key} = {stats[key]}")
    main_launches[p1_plane] = launches[p1_plane]
    failover_tick_ms = secs * 1e3 / 300
    log(json.dumps({
        "phase": "failover", "card": card,
        "acceptors": failover.num_acceptors, "ticks": 300, "seconds": secs,
        "ticks_per_s": 300 / secs, "committed_per_s": committed / secs,
        "committed": committed,
        "commit_latency_p50_ticks": stats["commit_latency_p50_ticks"],
        "commit_latency_p99_ticks": stats["commit_latency_p99_ticks"],
        "elections": stats["elections"] - s0["elections"],
        "reconfigurations": stats["reconfigurations"] - s0["reconfigurations"],
        "old_configs_gcd": stats["old_configs_gcd"],
        "alive_leaders": stats["alive_leaders"],
        "launches": launches,
    }))
    log(json.dumps(profile_ticks(
        tr.run, tr.block_until_ready, 20, card, "failover_profile",
        kernel="p1_promise",
    )))
    c1 = tr.committed()
    tr.leader_change()
    tr.reconfigure()
    run_checked(tr, 20)
    assert_invariants(tr, "failover after leader_change + reconfigure")
    if tr.committed() <= c1:
        raise AssertionError("no progress after leader_change + reconfigure")
    log(json.dumps({
        "phase": "failover_host", "card": card, "ticks": 20,
        "committed": tr.committed() - c1, "round": tr.stats()["round"],
    }))
    del tr
    torch.cuda.empty_cache()

    # -- 12. the flagship shape under a static fault plan ----------------------
    faulty = dataclasses.replace(flagship, faults=FaultPlan(
        drop_rate=0.05, jitter=1, crash_rate=0.01, revive_rate=0.2,
        partition=(0, 0, 1), partition_start=20, partition_heal=60,
    ))
    tr = TpuSimTransport(faulty, seed=0)
    registry.reset_launches()
    secs = run_checked(tr, 60)
    c_heal = tr.committed()
    secs += run_checked(tr, 40)
    launches = dict(registry.LAUNCHES)
    if (launches["multipaxos_fused_tick"], launches[p1_plane]) != (100, 100):
        raise AssertionError(f"faults launches: {launches}")
    assert_invariants(tr, "faults")
    stats = tr.stats()
    tel = tr.telemetry_summary()
    if tel["drops_total"] <= 0 or tel["retries_total"] <= 0 or (
        stats["elections"] <= 0
    ) or tr.committed() <= c_heal:
        raise AssertionError(
            f"faults: drops {tel['drops_total']}, retries "
            f"{tel['retries_total']}, elections {stats['elections']}, "
            f"committed {c_heal} -> {tr.committed()}"
        )
    log(json.dumps({
        "phase": "faults", "card": card, "ticks": 100, "seconds": secs,
        "ticks_per_s": 100 / secs, "committed": tr.committed(),
        "committed_after_heal": tr.committed() - c_heal,
        "drops": tel["drops_total"], "retries": tel["retries_total"],
        "elections": stats["elections"], "launches": launches,
    }))
    del tr
    torch.cuda.empty_cache()

    # -- 13. BASELINE config 4: Matchmaker churn -------------------------------
    def churn_run(every: int) -> dict:
        cfg = mpb.BatchedMultiPaxosConfig(
            f=1, num_groups=256, window=64, slots_per_tick=4, lat_min=1,
            lat_max=3, retry_timeout=16, reconfigure_every=every,
        )
        sim = TpuSimTransport(cfg, seed=3)
        sim.run(100)
        base = sim.committed()
        timeline = []
        t0 = time.perf_counter()
        for _ in range(20):
            before = sim.committed()
            sim.run(25)
            timeline.append(sim.committed() - before)
        secs = time.perf_counter() - t0
        assert_invariants(sim, f"config 4 reconfigure_every={every}")
        st = sim.stats()
        return {
            "committed": sim.committed() - base,
            "per_tick": (sim.committed() - base) / 500,
            "ticks_per_s": 500 / secs,
            "p50_latency_ticks": st["commit_latency_p50_ticks"],
            "reconfigurations": st.get("reconfigurations", 0),
            "old_configs_gcd": st.get("old_configs_gcd", 0),
            "timeline_committed_per_segment": timeline,
        }

    churn_free = churn_run(0)
    churned = churn_run(100)
    if churned["reconfigurations"] <= 0 or churned["committed"] <= 0:
        raise AssertionError(f"config 4: {churned}")
    log(json.dumps({
        "phase": "config4_matchmaker_churn", "card": card,
        "churn_free": churn_free, "with_churn": churned,
        "throughput_retained": churned["per_tick"] / churn_free["per_tick"],
    }))

    # -- 14. MultiPaxos failure path, card against CPU --------------------------
    small = mpb.BatchedMultiPaxosConfig(
        f=1, num_groups=4, window=16, slots_per_tick=2, lat_min=1, lat_max=3,
        retry_timeout=8, fail_rate=0.02, revive_rate=0.2, heartbeat_timeout=4,
        device_elections=True, reconfigure_every=15,
        faults=FaultPlan(
            drop_rate=0.1, dup_rate=0.2, jitter=1, crash_rate=0.01,
            revive_rate=0.3, partition=(0, 1, 0), partition_start=10,
            partition_heal=40,
        ),
    )
    on_card = TpuSimTransport(small, seed=0)
    on_cpu = TpuSimTransport(small, seed=0, device="cpu")
    for tr in (on_card, on_cpu):
        tr.run(60)
        tr.leader_change()
        tr.run(30)
        tr.reconfigure()
        tr.run(30)
    a, b = mpb.state_to_numpy(on_card.state), mpb.state_to_numpy(on_cpu.state)
    bad = [k for k in a if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
    if bad or on_card.stats() != on_cpu.stats():
        raise AssertionError(f"failure path card vs CPU: leaves differ: {bad}")
    assert_invariants(on_card, "failure path card")
    log(f"failure path card == cpu: {len(a)} leaves equal after 120 ticks, "
        f"a leader change and a reconfiguration; {on_card.stats()}")

    # -- 15-22. Mencius and Fast MultiPaxos ------------------------------------
    mf = mencius_and_fmp(ctx)
    main_launches[MEN_PLANE] = mf[MEN_PLANE]
    main_launches[FMP_PLANE] = mf[FMP_PLANE]

    # -- 24-30. Horizontal MultiPaxos and Scalog --------------------------------
    hs = horizontal_and_scalog(ctx)
    main_launches[HZ_PLANE] = hs[HZ_PLANE]
    main_launches[SC_PLANE] = hs[SC_PLANE]

    # -- 33-41. CRAQ and BPaxos ---------------------------------------------------
    cd = craq_and_bpaxos(ctx)
    main_launches[CR_PLANE] = cd[CR_PLANE]
    main_launches[DG_PLANE] = cd[DG_PLANE]

    # -- 43-45. the six-pass grid vote and the port's microbench -----------------
    uf_err = check_unfused(ctx)
    uf_row = time_unfused(ctx)
    mbench = run_microbench(ctx)
    uf_row["launches"] = mbench["launches"][UF_PLANE]
    uf_row["max_abs_err"] = uf_err
    log(json.dumps({
        "phase": "grid_vote_race", "card": card,
        "unfused_ms": uf_row["ms"], "fused_ms": uf_row["fused_ms"],
        "unfused_device_ms": uf_row["device_ms"],
        "unfused_device_ms_cold": uf_row["device_ms_cold"],
        "fused_device_ms_cold": uf_row["fused_device_ms_cold"],
        "pass_device_ms_cold": {
            p: v["device_ms_cold"] for p, v in uf_row["passes"].items()},
        "grid_vote_json_speedup": mbench["grid_vote"]["speedup"],
        "fused_tick_json_speedup": mbench["fused_tick"]["speedup"],
    }))

    # -- 23. timing at the main shapes -----------------------------------------
    # int32 operations per acceptor-slot and per slot (vote step,
    # dispatch slot body), counted from the kernel source.
    ops_per = {
        "vote": (14, 4), "dispatch": (8, 45), "tick": (24, 50), "p1": (6, 6),
    }
    rows = []
    for which, (kern, plain, plane) in kernels.items():
        args, st = plane_args(mp, which, FLAGSHIP, seed=7, age=True)
        launch, outs = mp.prepared_launch(plane, *args, **st)
        moved = nbytes(args) + nbytes(outs)
        # The phase-1 plane needs only part of its inputs: count what
        # these inputs need (ops/multipaxos.py p1_promise_needed_bytes).
        needed = mp.p1_promise_needed_bytes(args) if which == "p1" else moved
        per_acc, per_slot = ops_per[which]
        ops = A * G * W * per_acc + G * W * per_slot
        bytes_ms = needed / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / INT32_OPS_PER_S * 1e3
        # The kernel alone, then the whole wrapper (input checks and
        # output allocation on the host, then the launch).
        ms = time_ms(launch)
        dev_times = device_times(launch)
        wrapper_ms = time_ms(lambda: kern(*args, **st))
        plain_ms = time_ms(lambda: plain(*args, **st), reps=10)
        rows.append({
            "name": plane,
            "route": "cuda",
            "source": registry.PLANES[plane].source,
            "replaces": registry.PLANES[plane].replaces,
            "launches": main_launches[plane],
            "launches_per_tick": 2 if which == "p1" else 1,
            "exact": True,
            "max_abs_err": max_err[plane],
            "ms": ms,
            **dev_times,
            "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": moved,
            "library_ms": None,
        })
        if which == "p1":
            status, _, _, _, _, _, _, mask = args[:8]
            in_flight = (status == mp.PROPOSED) & mask[:, None]
            # The failover path's inputs: about 1% of the groups masked.
            sparse = mp.to_torch(mp.example_p1_promise_args(
                np.random.default_rng(7), A, G, W, case="sparse"), "cuda")
            sparse_launch, _ = mp.prepared_launch(plane, *sparse)
            sparse_needed = mp.p1_promise_needed_bytes(sparse)
            sparse_times = device_times(sparse_launch)
            rows[-1].update({
                "device_ms_cold_sparse": sparse_times["device_ms_cold"],
                "device_ms_cold_clean_sparse": sparse_times["device_ms_cold_clean"],
                **yardstick_keys(needed),
                **yardstick_keys(sparse_needed, "_sparse"),
                "bound_bytes": needed,
                "in_flight_share": int(in_flight.sum()) / (G * W),
                "launch_route": launch.route,
                "route_launches": p1_routes,
                "bound_ms_sparse": sparse_needed / HBM_BYTES_PER_S * 1e3,
                "bound_bytes_sparse": sparse_needed,
            })

    # The grid-vote kernel at the Compartmentalized main shape. Its bound
    # counts the bytes these inputs need: every input and output once,
    # except the latencies and masks the kernel reads only where they are
    # used (grid_vote_needed).
    args = registry.to_torch(
        czo.example_grid_vote_args(np.random.default_rng(7), *CZ_MAIN), "cuda"
    )
    st = dict(retry_timeout=16)
    launch, outs = czo.prepared_launch(*args, **st)
    moved = nbytes(args) + nbytes(outs)
    needed, _ = grid_vote_needed(czo, args, st)
    cells, rep_cells = R * C * G_cz * W_cz, NR * G_cz * W_cz
    # int32 operations per grid cell, replica cell and slot, counted from
    # the kernel source.
    ops = cells * 12 + rep_cells * 10 + G_cz * W_cz * 20
    bytes_ms = needed / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    ms = time_ms(launch)
    dev_times = device_times(launch)
    wrapper_ms = time_ms(lambda: czo.fused_grid_vote(*args, **st))
    plain_ms = time_ms(lambda: czo.reference_grid_vote(*args, **st), reps=10)
    rows.append({
        "name": cz_plane,
        "route": "cuda",
        "source": registry.PLANES[cz_plane].source,
        "replaces": registry.PLANES[cz_plane].replaces,
        "launches": main_launches[cz_plane],
        "launches_per_tick": 1,
        "exact": True,
        "max_abs_err": max_err[cz_plane],
        "ms": ms,
        **dev_times,
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": moved,
        "bound_bytes": needed,
        **yardstick_keys(needed),
        "launch_route": launch.route,
        "route_launches": cz_routes,
        "library_ms": None,
    })
    cz_sweep_ms = time_ms(
        lambda: prng.bits(prng.PRNGKey(0), (R, C, G_cz, W_cz), "cuda"), reps=10
    )
    log(json.dumps({
        "phase": "cz_tick_split", "card": card, "tick_ms": cz_tick_ms,
        "grid_vote_kernel_ms": ms, "threefry_sweep_RCGW_ms": cz_sweep_ms,
        "rest_ms": cz_tick_ms - ms,
    }))

    # The rest of a tick: the threefry sweeps and field cutting in torch.
    key = prng.PRNGKey(0)
    sweep_ms = time_ms(lambda: prng.bits(key, (A, G, W), "cuda"), reps=10)
    log(json.dumps({
        "phase": "tick_split", "card": card, "tick_ms": tick_ms,
        "fused_tick_kernel_ms": rows[2]["ms"],
        "threefry_sweep_AGW_ms": sweep_ms,
        "rest_ms": tick_ms - rows[2]["ms"],
    }))
    log(json.dumps({
        "phase": "failover_tick_split", "card": card,
        "tick_ms": failover_tick_ms, "healthy_tick_ms": tick_ms,
        "fused_tick_kernel_ms": rows[2]["ms"],
        "p1_promise_kernel_ms_x2": 2 * rows[3]["ms"],
        "rest_ms": failover_tick_ms - rows[2]["ms"] - 2 * rows[3]["ms"],
    }))

    vote_rows = vote_kernel_rows(ctx, main_launches, max_err, mf)
    rows += vote_rows
    men_sweep_ms = time_ms(
        lambda: prng.bits(prng.PRNGKey(0), MEN_SHAPES[0], "cuda"), reps=10
    )
    log(json.dumps({
        "phase": "mencius_fmp_tick_split", "card": card,
        "mencius_tick_ms": mf["mencius_tick_ms"],
        "mencius_100k_tick_ms": mf["mencius_100k_tick_ms"],
        "fmp_tick_ms": mf["fmp_tick_ms"],
        "fmp_100k_tick_ms": mf["fmp_100k_tick_ms"],
        "mencius_vote_kernel_ms": vote_rows[0]["ms"],
        "fmp_vote_kernel_ms": vote_rows[1]["ms"],
        "threefry_sweep_LWA_ms": men_sweep_ms,
    }))

    # -- 31. Horizontal and Scalog kernels and tick splits ---------------------
    hz_sc_rows = hz_sc_kernel_rows(ctx, main_launches, max_err, hs)
    rows += hz_sc_rows
    sweep_split(ctx, "horizontal_tick_split", hs["hz_tick_ms"],
                (HZ_SHAPES[0], HZ_SHAPES[0][:2]))
    sweep_split(ctx, "scalog_tick_split", hs["sc_tick_ms"], ((SC_SHAPES[0][1],),))
    log(json.dumps({
        "phase": "horizontal_scalog_ticks", "card": card,
        "hz_tick_ms": hs["hz_tick_ms"], "hz_100k_tick_ms": hs["hz_100k_tick_ms"],
        "sc_tick_ms": hs["sc_tick_ms"], "sc_256_tick_ms": hs["sc_256_tick_ms"],
        "horizontal_vote_kernel_ms": hz_sc_rows[0]["ms"],
        "scalog_cut_commit_kernel_ms": hz_sc_rows[1]["ms"],
    }))

    # -- 42. CRAQ and BPaxos kernels and tick splits -------------------------------
    cd_rows, dg_model = craq_dg_kernel_rows(ctx, main_launches, max_err, cd)
    rows += cd_rows
    log(json.dumps({"phase": "depgraph_schedule_model", **dg_model}))
    for row in rows:
        if row["name"] in repaired_timing:
            row["repaired_shapes"] = repaired_timing[row["name"]]
    N, W, L, KV = CR_SHAPES[0]
    sweep_split(ctx, "craq_tick_split", cd["cr_tick_ms"], ((N, W), (N, 32)))
    bp_cfg = cd["dg_state"][0]
    Lb, Wb, R = bp_cfg.num_leaders, bp_cfg.window, bp_cfg.num_replicas
    sweep_split(ctx, "bpaxos_tick_split", cd["dg_tick_ms"], (
        (4, Lb, bp_cfg.cmds_per_tick, dgo.num_words(bp_cfg.num_vertices)),
        (4, Lb, Wb), (R, Lb, Wb),
    ))
    log(json.dumps({
        "phase": "craq_bpaxos_ticks", "card": card,
        **{k: v for k, v in cd.items() if k.endswith("_ms")},
        "craq_chain_kernel_ms": cd_rows[0]["ms"],
        "depgraph_execute_kernel_ms": cd_rows[1]["ms"],
    }))

    rows.append(uf_row)
    # A kernel cannot beat the least time of its work from a cold L2: a
    # share above 1 means a wrong byte count or a wrong timing.
    for row in rows:
        row["share_of_bound_cold"] = row["bound_ms"] / row["device_ms_cold"]
    log(json.dumps({
        "phase": "share_of_bound_cold", "card": card,
        **{row["name"]: row["share_of_bound_cold"] for row in rows},
    }))
    over = [row["name"] for row in rows if row["share_of_bound_cold"] > 1]
    if over:
        raise AssertionError(f"cold device time under the bound: {over}")

    log(f"card: {card}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": count},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
