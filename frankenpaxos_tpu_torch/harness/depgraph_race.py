"""Race variants of the execute kernel (``csrc/depgraph.cu``) on the card:

    python -m frankenpaxos_tpu_torch.harness.depgraph_race [--reps 5]

A variant is a text edit of the committed source: ``kG``, the active words
of a row one thread takes in the closure (1, 2 or 4), and whether rounds
after the first pull only the rows written in the round before (``dirty``)
or every row a row reaches. Each variant is built with ``nvcc`` (one
process each, all started together) into ``<build dir>/depgraph_race/``.

The inputs are the execute plane's on the BPaxos points of
``chip_smoke.py`` (5 leaders, 5 replicas, window 64 at conflict 1/4 after
100 + 300 ticks and at conflict 1, window 256 after 50 ticks, driven
through ``init_state`` / ``run_ticks``), then three check graphs: an
all-active dense graph and the long path at V = 1280, and the
microbench's 208 graphs of V = 64. Every variant's outputs are checked
bit for bit against the plain version on every input; then each is timed,
``reps`` times in interleaved order: CUDA events around 200 launches
queued behind a sleep kernel, so the time is the kernel's own, back to
back. One JSON line a case: the card, each variant's times (ms a launch)
and its rounds per graph. Needs the card; it writes nothing but the
builds.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from frankenpaxos_tpu_torch import prng
from frankenpaxos_tpu_torch.ops import _build
from frankenpaxos_tpu_torch.ops import depgraph as dgo
from frankenpaxos_tpu_torch.tpu import bpaxos_batched as bb

SOURCE = os.path.join(_build.CSRC_DIR, "depgraph.cu")
_KG = "constexpr int kG = 2;"
# The dirty-row pulls, and what each line becomes without them.
_NO_DIRTY = {
    "const unsigned pull_all = (prev[i >> 5] & self) ? kFull : 0u;":
        "const unsigned pull_all = kFull; (void)prev;",
    "if (wrote) atomicOr(&cur[i >> 5], self);": "(void)cur; (void)self;",
    "for (int w = tid; w < VW; w += nthreads) next[w] = 0u;": "(void)next;",
}
VARIANTS: Dict[str, Tuple[int, bool]] = {
    f"g{g}{'' if dirty else '_nodirty'}": (g, dirty)
    for dirty in (True, False) for g in (2, 1, 4)
}


def variant_source(g: int, dirty: bool) -> str:
    """The committed source with ``kG = g``, and without the dirty-row
    pulls unless ``dirty``."""
    with open(SOURCE) as f:
        src = f.read()
    for old in (_KG, *_NO_DIRTY):
        if src.count(old) != 1:
            raise RuntimeError(f"depgraph.cu no longer holds {old!r} once")
    src = src.replace(_KG, f"constexpr int kG = {g};")
    if not dirty:
        for old, new in _NO_DIRTY.items():
            src = src.replace(old, new)
    return src


def build_variants() -> Dict[str, ctypes.CDLL]:
    out = os.path.join(_build.build_dir(), "depgraph_race")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, (g, dirty) in VARIANTS.items():
        src = os.path.join(out, f"{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(g, dirty))
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
        lib = ctypes.CDLL(so)
        lib.fpx_depgraph_launch.restype = ctypes.c_int
        lib.fpx_depgraph_launch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
        ]
        libs[name] = lib
    return libs


def launcher(lib, adj, com, act):
    """``(launch, outputs, rounds)`` for one variant, packed as the
    wrapper packs the committed kernel."""
    B, V, VW = adj.shape
    _, shared = dgo.working_set(V)
    dev = adj.device
    t = dict(
        adj=adj, com=com, act=act,
        work=None if shared else torch.empty((B, dgo.scratch_words(V)), dtype=torch.int32,
                                             device=dev),
        o_elig=torch.empty((B, V), dtype=torch.bool, device=dev),
        o_order=torch.empty((B, V), dtype=torch.int32, device=dev),
        o_root=torch.empty((B, V), dtype=torch.int32, device=dev),
        o_rounds=torch.empty((B,), dtype=torch.int32, device=dev),
    )
    ptrs = (ctypes.c_void_p * len(dgo._PTR_SLOTS))(
        *[None if t[s] is None else t[s].data_ptr() for s in dgo._PTR_SLOTS])
    ints = (ctypes.c_int * 6)(B, V, VW, adj.stride(0), int(shared), dgo.default_threads(V))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch() -> None:
        err = lib.fpx_depgraph_launch(ptrs, ints, stream)
        if err:
            raise RuntimeError(f"depgraph_race: launch failed (cuda error {err})")

    return launch, (t["o_elig"], t["o_order"], t["o_root"]), t["o_rounds"]


def per_launch_ms(launch, n: int = 200) -> float:
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # the host queues the launches meanwhile
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        launch()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def bpaxos_inputs(cfg, segments):
    """The execute plane's inputs after segments of ticks of seed 0 (each
    keyed ``fold_in(key, segment)``, as ``chip_smoke.py`` runs them), as the
    tick builds them: the shared adjacency as a stride-0 batch, and each
    replica's (committed, active) view."""
    state, t = bb.init_state(cfg), 0
    for k, ticks in enumerate(segments):
        state, t = bb.run_ticks(cfg, state, t, ticks, prng.fold_in(prng.PRNGKey(0), k))
    W, R, V = cfg.window, cfg.num_replicas, cfg.num_vertices
    abs_now = bb._abs_slot(state.gc_head, W)
    com = state.proposed[None] & (state.rep_commit_tick <= t)
    act = state.proposed[None] & (abs_now[None] >= state.head_r[:, :, None])
    adj = state.adj.expand(R, V, state.adj.shape[1])
    return adj, com.reshape(R, V).contiguous(), act.reshape(R, V).contiguous()


def inputs() -> dict:
    bp = bb.BatchedBPaxosConfig(
        num_leaders=5, window=64, cmds_per_tick=2, num_replicas=5,
        conflict_rate=0.25, lat_min=1, lat_max=3,
    )
    out = {
        "bpaxos_320": bpaxos_inputs(bp, (100, 300)),
        "bpaxos_dense_320": bpaxos_inputs(dataclasses.replace(bp, conflict_rate=1.0),
                                          (100, 300)),
        "bpaxos_1280": bpaxos_inputs(dataclasses.replace(bp, window=256), (50,)),
    }
    for name, B, V, case, density, all_active in (
        ("dense_1280", 5, 1280, "random", 0.5, True),
        ("long_path_1280", 5, 1280, "long_path", 0.12, False),
        ("micro_208x64", 208, 64, "random", 0.06, False),
    ):
        adj, com, act = dgo.example_depgraph_args(
            np.random.default_rng(V), B, V, case=case, density=density)
        if all_active:
            act = np.ones_like(act)
        out[name] = (torch.from_numpy(adj.view(np.int32).copy()).cuda(),
                     torch.from_numpy(com).cuda(), torch.from_numpy(act).cuda())
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("depgraph_race: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    libs = build_variants()
    for case, plane in inputs().items():
        want = dgo.reference_depgraph_execute(*plane)
        launches, rounds = {}, {}
        for name, lib in libs.items():
            launch, outs, r = launcher(lib, *plane)
            launch()
            torch.cuda.synchronize()
            for w, g in zip(want, outs):
                if not torch.equal(w, g):
                    raise AssertionError(f"depgraph_race: {case}: {name} differs")
            launches[name], rounds[name] = launch, r.tolist()
        times = {name: [] for name in libs}
        order = list(libs)
        for k in range(args.reps):
            for name in order if k % 2 == 0 else order[::-1]:
                times[name].append(per_launch_ms(launches[name]))
        print(json.dumps({
            "case": case, "card": card, "shape": list(plane[0].shape),
            "active": int(plane[2].sum()), "ms": times,
            "median_ms": {n: statistics.median(t) for n, t in times.items()},
            "rounds": {n: r[:8] for n, r in rounds.items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
