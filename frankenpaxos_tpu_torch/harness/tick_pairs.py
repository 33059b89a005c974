"""Ticks/s of the Mencius, Fast MultiPaxos and Scalog points of
``chip_smoke.py``, and the host cost of one call of their plane wrappers,
for this checkout and another one, in alternating processes on one card:

    python -m frankenpaxos_tpu_torch.harness.tick_pairs --parent DIR [--rounds 2]
        [--backends mencius fastmultipaxos scalog]

The points, as ``chip_smoke.py`` phases 15-20 and 28 drive them (seed 0):
Mencius and Fast MultiPaxos at 10,002 acceptors (100 warm-up ticks, then
300 timed), at 100,002 acceptors (50 ticks from a cold state) and under
the static fault plan of drops, jitter, crashes and a healing cut (60 and
40 ticks from a cold state); Scalog at 256 and 10,000 shards (100 warm-up
ticks, then 300 timed). The profiled ticks of ``chip_smoke.py`` are left
out, but at each Scalog point 20 more ticks run under ``torch.profiler``:
the device time a tick of the cut-commit kernel (the events whose name
holds ``scalog``) and of every memset, and their launches a tick, so the
two checkouts' kernel, or memset and kernel, show side by side. The host
cost a call of ``fused_mencius_vote``, ``fused_fmp_vote``
and ``fused_scalog_cut_commit`` at their main shapes (seed 7, as the
kernels line draws them) on the card: the least, over 10 batches, of a
batch of 200 calls back to back without a synchronize over 200 (the
kernel, 5-12 us, is shorter than the call, so the host sets the pace);
where the checkout's wrappers choose a route (``mencius_vote_route``,
``fmp_vote_route``, ``scalog_cut_commit_route``), that choice's own host
cost a call the same way, so the part of a difference it explains shows.

Each round runs the other checkout, this one, this one, the other one,
each in a fresh process whose ``PYTHONPATH`` is that checkout's root (the
same code below drives both; it calls only entry points both have). Each
process prints one JSON line; the last line holds the medians of each
checkout. Needs the card; it writes nothing but the builds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
BATCHES, CALLS = 10, 200
# The card, and the leaders / groups of the 10k and 100k points (a quarter
# of the Mencius leaders, rounded up, idle).
DEVICE = "cuda"
GROUPS = (3334, 33334)


def _timed(mod, prng, cfg, warm: int, segments) -> tuple:
    """``(seconds of the timed ticks, commands committed in all)``
    (Mencius: real commands; Fast MultiPaxos: commands done) after
    ``warm`` untimed ticks and timed segments of ``segments`` ticks, one
    key a segment (``fold_in`` of seed 0's key by the segment's number,
    as ``chip_smoke.py`` ``BatchedSim`` keys them)."""
    import torch

    key = prng.PRNGKey(0)
    state, t = mod.init_state(cfg, device=DEVICE), 0
    runs = [(n, False) for n in (warm,) if n] + [(n, True) for n in segments]
    secs = 0.0
    for i, (n, timed) in enumerate(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, t = mod.run_ticks(cfg, state, t, n, prng.fold_in(key, i))
        torch.cuda.synchronize()
        secs += (time.perf_counter() - t0) if timed else 0.0
    if mod.__name__.endswith("mencius_batched"):
        return secs, int(state.committed_real)
    if mod.__name__.endswith("scalog_batched"):
        return secs, int(state.global_len)
    return secs, int(mod.stats(cfg, state, t)["cmds_done"])


PROFILED_TICKS = 20


def _profiled(mod, prng, cfg, warm: int) -> dict:
    """Device ms and launches a tick of the cut-commit kernel and of the
    memsets over :data:`PROFILED_TICKS` ticks under ``torch.profiler``,
    after ``warm`` untimed ticks (keys as :func:`_timed`'s)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    key = prng.PRNGKey(0)
    state, t = mod.run_ticks(cfg, mod.init_state(cfg, device=DEVICE), 0, warm,
                             prng.fold_in(key, 0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mod.run_ticks(cfg, state, t, PROFILED_TICKS, prng.fold_in(key, 1))
        torch.cuda.synchronize()
    out = {}
    for what, part in (("kernel", "scalog"), ("memset", "emset")):
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and part in e.key]
        us = sum(float(getattr(e, "self_device_time_total", 0.0) or 0.0)
                 for e in events)
        out[f"{what}_device_ms_per_tick"] = us / 1e3 / PROFILED_TICKS
        out[f"{what}s_per_tick"] = sum(e.count for e in events) / PROFILED_TICKS
    return out


def _host_us(fn, args, statics) -> float:
    """The least host time a call of ``fn`` over :data:`BATCHES` batches
    of :data:`CALLS` calls, in us."""
    import torch

    fn(*args, **statics)
    best = float("inf")
    for _ in range(BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn(*args, **statics)
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / CALLS * 1e6


BACKENDS = ("mencius", "fastmultipaxos", "scalog")


def child(backends=BACKENDS) -> dict:
    """This process's points of ``backends``, on the checkout its
    ``PYTHONPATH`` names."""
    import numpy as np

    import frankenpaxos_tpu_torch
    from frankenpaxos_tpu_torch import prng
    from frankenpaxos_tpu_torch.ops import fastmultipaxos as fmo
    from frankenpaxos_tpu_torch.ops import mencius as meo
    from frankenpaxos_tpu_torch.ops import registry
    from frankenpaxos_tpu_torch.ops import scalog as sco
    from frankenpaxos_tpu_torch.tpu import fastmultipaxos_batched as fb
    from frankenpaxos_tpu_torch.tpu import mencius_batched as mb
    from frankenpaxos_tpu_torch.tpu import scalog_batched as sb
    from frankenpaxos_tpu_torch.tpu.faults import FaultPlan

    out = {"root": os.path.dirname(os.path.dirname(frankenpaxos_tpu_torch.__file__))}
    plan = FaultPlan(
        drop_rate=0.05, jitter=1, crash_rate=0.01, revive_rate=0.2,
        partition=(0, 0, 1), partition_start=20, partition_heal=60,
    )
    men = mb.BatchedMenciusConfig(
        f=1, num_leaders=GROUPS[0], window=32, slots_per_tick=4,
        skip_threshold=16, lat_min=1, lat_max=3, retry_timeout=16,
        num_idle_leaders=(GROUPS[0] + 2) // 4,
    )
    fmp = fb.BatchedFastMultiPaxosConfig(
        f=1, num_groups=GROUPS[0], window=32, cmd_window=32, cmds_per_tick=2,
        lat_min=1, lat_max=3, jitter=2, recovery_timeout=10, retry_timeout=12,
    )
    points = (
        ("mencius", mb, men, 100, (300,)),
        ("mencius_100k", mb, dataclasses.replace(
            men, num_leaders=GROUPS[1], num_idle_leaders=(GROUPS[1] + 2) // 4),
         0, (50,)),
        ("mencius_faults", mb, dataclasses.replace(
            men, drop_rate=0.05, faults=plan), 0, (60, 40)),
        ("fastmultipaxos", fb, fmp, 100, (300,)),
        ("fastmultipaxos_100k", fb,
         dataclasses.replace(fmp, num_groups=GROUPS[1]), 0, (50,)),
        ("fastmultipaxos_faults", fb, dataclasses.replace(fmp, faults=plan),
         0, (60, 40)),
        ("scalog_256", sb, sb.BatchedScalogConfig(
            num_shards=256, appends_per_tick=8), 100, (300,)),
        ("scalog", sb, sb.BatchedScalogConfig(
            num_shards=10000, appends_per_tick=8), 100, (300,)),
    )
    for name, mod, cfg, warm, segments in points:
        if not name.startswith(backends):
            continue
        secs, done = _timed(mod, prng, cfg, warm, segments)
        out[name] = {"ticks_per_s": sum(segments) / secs, "entries_total": done}
        if name.startswith("scalog"):
            out.update({f"{name}_{k}": v
                        for k, v in _profiled(mod, prng, cfg, warm).items()})
    cases = (
        ("mencius_vote", meo, "fused_mencius_vote", "mencius_vote_route",
         meo.example_mencius_vote_args(np.random.default_rng(7), 3334, 32, 3), {}),
        ("fastmultipaxos_vote", fmo, "fused_fmp_vote", "fmp_vote_route",
         fmo.example_fmp_vote_args(np.random.default_rng(7), 3, 3334, 32),
         dict(fq=3, f=1, recovery_timeout=10)),
        ("scalog_cut_commit", sco, "fused_scalog_cut_commit",
         "scalog_cut_commit_route",
         sco.example_scalog_cut_commit_args(np.random.default_rng(7), 8, 10000), {}),
    )
    for name, mod, kernel, route, args, st in cases:
        if not name.startswith(backends):
            continue
        args = registry.to_torch(args, DEVICE)
        out[f"{name}_host_us"] = _host_us(getattr(mod, kernel), args, st)
        if hasattr(mod, route):
            out[f"{name}_route_host_us"] = _host_us(getattr(mod, route), args[:-1], {})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--backends", nargs="+", choices=BACKENDS,
                    default=list(BACKENDS))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.child:
        import torch

        if not torch.cuda.is_available():
            print("tick_pairs: no CUDA device", file=sys.stderr)
            return 1
        print(json.dumps(child(tuple(opts.backends))), flush=True)
        return 0
    if not opts.parent:
        ap.error("--parent DIR is required")
    roots = {"parent": os.path.abspath(opts.parent), "change": ROOT}
    runs = {"parent": [], "change": []}
    for _ in range(opts.rounds):
        for which in ("parent", "change", "change", "parent"):
            env = dict(os.environ, PYTHONPATH=roots[which])
            proc = subprocess.run(
                [sys.executable, HERE, "--child", "--backends", *opts.backends],
                cwd=roots[which], env=env,
                capture_output=True, text=True, timeout=900,
            )
            if proc.returncode:
                sys.stderr.write(proc.stderr[-4000:])
                return proc.returncode
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"checkout": which, **line}), flush=True)
            runs[which].append(line)
    summary = {}
    for which, lines in runs.items():
        keys = [k for k in lines[0] if k != "root"]
        summary[which] = {
            k: statistics.median(
                ln[k]["ticks_per_s"] if isinstance(ln[k], dict) else ln[k]
                for ln in lines)
            for k in keys
        }
    print(json.dumps({"medians": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
