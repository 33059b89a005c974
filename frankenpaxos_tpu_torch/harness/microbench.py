"""Device microbenchmarks of the port (the counterpart of the device
benches of ``frankenpaxos_tpu/harness/microbench.py``):

    python -m frankenpaxos_tpu_torch.harness.microbench            # all
    python -m frankenpaxos_tpu_torch.harness.microbench kernels fused_tick grid_vote

Each bench prints ``name,case,ops,seconds,ops_per_sec`` rows and one
JSON line:

* ``kernels`` (``KERNELS_JSON``): every registered plane's plain version
  timed on the cases of :func:`kernel_cases`; on the card also its
  kernel, whose outputs are checked against the plain ones (``parity``).
  Each plane's entry carries the bytes its inputs and outputs take.
* ``fused_tick`` (``FUSED_TICK_JSON``): the whole-tick kernel against
  the planes it replaces (clock aging, the vote kernel, the dispatch
  kernel).
* ``grid_vote`` (``GRID_VOTE_JSON``): the fused grid-vote kernel against
  its six-pass twin (``ops.compartmentalized.unfused_grid_vote``).
* ``depgraph`` (``DEPGRAPH_JSON``): the batched closure (the plain
  version, and on the card the execute kernel) against the host
  pointer walk (``ops.depgraph.oracle_execute``) on the same graphs.

The entry points run on the card (``device=None``) and raise without
one; ``device="cpu"`` runs them on the CPU, where every wrapper runs its
plain version: ``kernels`` then times the plain versions alone and
reports ``parity: null``, ``fused_tick`` races the plain whole tick
against the three plain planes, and ``grid_vote`` the plain fused grid
vote against the six plain passes. Races check their two sides' outputs
equal (values and dtypes, ``bit_identical``) and keep the best of
``rounds`` interleaved timings, each a host clock around work that ends
in ``torch.cuda.synchronize()``. The benches write no file.

Left out, with no counterpart in the port yet: the Pallas block sweep
(``AUTOTUNE_BLOCKS``, ``best_block``, ``block_sweep_seconds``,
``dispatch_block``: the port's ``block`` is groups per CTA, and each
kernel picks its own), the autotune-table write, the cost-model fields
(``predicted_per_sec``, ``efficiency``), the host data-structure benches
and the ``hbm``, ``telemetry``, ``faults``, ``workload``, ``packing``,
``costmodel``, ``mesh_kernels`` and ``fleet`` benches (``ROADMAP.md``).
"""

from __future__ import annotations

import functools
import json
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from frankenpaxos_tpu_torch import prng
from frankenpaxos_tpu_torch.ops import compartmentalized as czo
from frankenpaxos_tpu_torch.ops import depgraph as dgo
from frankenpaxos_tpu_torch.ops import multipaxos as mpo
from frankenpaxos_tpu_torch.ops import registry
from frankenpaxos_tpu_torch.tpu.common import INF, INF16, age_clock, resolve_device


def _timed(fn: Callable[[], int]) -> Tuple[int, float]:
    start = time.perf_counter()
    ops = fn()
    return ops, time.perf_counter() - start


def _report(name: str, case: str, ops: int, seconds: float) -> dict:
    row = {
        "name": name,
        "case": case,
        "ops": ops,
        "seconds": round(seconds, 4),
        "ops_per_sec": round(ops / seconds) if seconds > 0 else 0,
    }
    print(
        f"{row['name']},{row['case']},{row['ops']},{row['seconds']},"
        f"{row['ops_per_sec']}"
    )
    return row


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _tree_equal(a, b) -> bool:
    """Equal leaf by leaf: the same values and the same dtypes."""
    la, lb = _leaves(a), _leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            return False
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape:
                return False
            if not torch.equal(x.cpu(), y.cpu()):
                return False
        elif type(x) is not type(y) or x != y:
            return False
    return True


def _nbytes(tree) -> int:
    return sum(
        x.numel() * x.element_size()
        for x in _leaves(tree)
        if isinstance(x, torch.Tensor)
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _repeat(fn: Callable, iters: int, device: torch.device) -> Callable[[], int]:
    """``iters`` calls of ``fn``, then a synchronise: a timed segment."""

    def run() -> int:
        for _ in range(iters):
            fn()
        _sync(device)
        return iters

    return run


def _interleaved_best(contenders: Dict[str, Callable], iters: int, rounds: int,
                      device: torch.device) -> Dict[str, float]:
    """Best seconds of ``iters`` calls per contender over ``rounds``
    rounds, every contender sampled once a round in turn, so the sides
    see the same drift of the machine."""
    best = {case: float("inf") for case in contenders}
    for _ in range(rounds):
        for case, fn in contenders.items():
            _, seconds = _timed(_repeat(fn, iters, device))
            best[case] = min(best[case], seconds)
    return best


def kernel_cases(A=3, G=3334, W=64, N=3334, L=3, KV=16, CW=16, seed=0,
                 device=None):
    """Random dtype-policy inputs for every registered kernel plane
    (flagship-shaped by default): ``{plane: (args, statics)}``. Drawn with
    the port's PRNG in the order ``_kernel_cases`` of the JAX package
    draws them, so every array equals the JAX case's, dtype included.
    Two leaves differ in type only: the tick ``t`` is a Python int (the
    port's wrappers take the tick as an int; JAX has an int32 scalar),
    and the dependency graphs are packed into int32 words with the bits
    of JAX's uint32 words (the port's word type)."""
    dev = resolve_device(device)
    i16, i8, i32 = torch.int16, torch.int8, torch.int32
    keys = iter(prng.split(prng.PRNGKey(seed), 128))

    def nxt():
        return next(keys)

    def uniform(shape):
        return prng.uniform(nxt(), shape, device=dev)

    def randint(shape, lo, hi):
        return prng.randint(nxt(), shape, lo, hi, device=dev)

    def where(cond, x, y):
        return torch.where(cond, x, y).to(i32)

    def clock(shape, p=0.35):
        return torch.where(
            uniform(shape) < p, randint(shape, -1, 5), INF16
        ).to(i16)

    def lat16(shape):
        return randint(shape, 1, 4).to(i16)

    def full(shape, value, dtype=i32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    t = 33
    cases: Dict[str, tuple] = {}

    # ---- MultiPaxos planes, acceptor-major [A, G, W].
    status = randint((G, W), 0, 3).to(i8)
    slot_value = where(status > 0, randint((G, W), 0, 10000), -1)
    propose_tick = where(status > 0, randint((G, W), 0, 30), INF)
    last_send = where(status > 0, randint((G, W), 0, 33), INF)
    chosen_tick = where(status == 2, randint((G, W), 0, 33), INF)
    chosen_round = torch.where(status == 2, 1, -1).to(i16)
    chosen_value = where(status == 2, slot_value, -1)
    replica_arrival = where(status == 2, randint((G, W), 30, 40), INF)
    p2a, p2b = clock((A, G, W)), clock((A, G, W))
    acc_round = randint((A, G), 0, 3).to(i16)
    leader_round = randint((G,), 0, 3).to(i16)
    vote_round = randint((A, G, W), -1, 3).to(i16)
    vote_value = where(vote_round >= 0, randint((A, G, W), 0, 10000), -1)
    head = randint((G,), 0, 100)
    group_ids = torch.arange(G, dtype=i32, device=dev)
    cases["multipaxos_vote_quorum"] = (
        (
            p2a, acc_round, leader_round, slot_value, vote_round,
            vote_value, p2b, lat16((A, G, W)),
            uniform((A, G, W)) < 0.9, head,
        ),
        {},
    )
    cases["multipaxos_p1_promise"] = (
        (
            status, vote_round, vote_value, slot_value, p2a, p2b,
            last_send, uniform((G,)) < 0.5,
            uniform((A, G)) < 0.7, lat16((A, G, W)), t,
        ),
        {},
    )
    cases["multipaxos_dispatch"] = (
        (
            status, slot_value, propose_tick, last_send, chosen_tick,
            chosen_round, chosen_value, replica_arrival, p2a, p2b,
            vote_round, vote_value,
            randint((G, W), 0, A + 1),  # nvotes
            head, head + randint((G,), 0, W + 1),
            leader_round, full((G,), 8),
            full((G,), True, torch.bool),
            uniform((A, G, W)) < 0.6,  # send_ok
            uniform((A, G, W)) < 0.9,  # retry_deliv
            lat16((A, G, W)), lat16((A, G, W)),
            randint((G, W), 1, 4),
            group_ids, t,
        ),
        dict(f=1, retry_timeout=16, num_groups=G),
    )
    # ---- The whole-tick kernel: the vote-plane args + the dispatch-only
    # args (clock aging folded in, age=True).
    cases["multipaxos_fused_tick"] = (
        (
            p2a, acc_round, leader_round, slot_value, vote_round,
            vote_value, p2b, lat16((A, G, W)),
            uniform((A, G, W)) < 0.9, head,
            status, propose_tick, last_send, chosen_tick,
            chosen_round, chosen_value, replica_arrival,
            head + randint((G,), 0, W + 1),
            full((G,), 8), full((G,), True, torch.bool),
            uniform((A, G, W)) < 0.6,  # send_ok
            uniform((A, G, W)) < 0.9,  # retry_deliv
            lat16((A, G, W)), lat16((A, G, W)),
            randint((G, W), 1, 4),
            group_ids, t,
        ),
        dict(f=1, retry_timeout=16, num_groups=G, age=True),
    )

    # ---- Fast MultiPaxos vote plane, acceptor-major [A, G, W]: few
    # distinct values so the pairwise-match census sees conflicts.
    fmp_vv = where(uniform((A, G, W)) < 0.6, randint((A, G, W), 0, 6), -1)
    fmp_status = randint((G, W), 0, 3).to(i8)
    cases["fastmultipaxos_vote"] = (
        (
            fmp_vv,
            where(fmp_vv >= 0, randint((A, G, W), 0, 37), INF),
            fmp_status,
            where(fmp_status > 0, randint((G, W), 0, 33), INF),
            where(uniform((G, W)) < 0.2, randint((G, W), 0, 6), -1),
            where(fmp_status == 1, randint((G, W), 0, 6), -1),
            where(
                (fmp_status == 1)[None] & (uniform((A, G, W)) < 0.5),
                randint((A, G, W), 32, 36),
                INF,
            ),
            where(
                (fmp_status == 1)[None] & (uniform((A, G, W)) < 0.4),
                randint((A, G, W), 31, 38),
                INF,
            ),
            (fmp_status == 1)[None] & (uniform((A, G, W)) < 0.4),
            where(fmp_status == 2, 1, -1),
            where(fmp_status == 2, randint((G, W), 33, 38), INF),
            randint((G, W), 1, 4),
            randint((G, W), 1, 4),
            t,
        ),
        dict(fq=2, f=1, recovery_timeout=10),
    )

    # ---- Horizontal vote plane, pool-major [P=2n, G, W].
    Pn = 6
    hz_status = randint((G, W), 0, 3).to(i8)
    hz_epoch = where(hz_status > 0, randint((G, W), 0, 4), -1).to(i16)
    hz_voted = (hz_status > 0)[None] & (uniform((Pn, G, W)) < 0.4)
    cases["horizontal_vote"] = (
        (
            hz_epoch,
            hz_status,
            where(hz_status > 0, randint((G, W), 0, 33), INF),
            where(
                (hz_status == 1)[None] & (uniform((Pn, G, W)) < 0.5),
                randint((Pn, G, W), 32, 36),
                INF,
            ),
            where(hz_voted, randint((Pn, G, W), 31, 38), INF),
            hz_voted,
            torch.where(hz_voted, hz_epoch[None], -1).to(i16),
            randint((Pn, G, W), 1, 4),
            uniform((Pn, G, W)) < 0.9,
            t,
        ),
        dict(n=3, quorum=2),
    )

    # ---- Scalog cut-commit plane, [P, S] with S = the shard axis.
    SP, SS = 8, N
    sc_cc = torch.tensor(5, dtype=i32, device=dev)
    slots = (sc_cc + torch.arange(SP, dtype=i32, device=dev)) % SP
    sc_vec_asc = randint((SS,), 0, 20)[None, :] + torch.cumsum(
        randint((SP, SS), 0, 5), dim=0, dtype=i32
    )
    cut_vec = full((SP, SS), 0)
    cut_vec[slots] = sc_vec_asc
    commit_tick = full((SP,), INF)
    commit_tick[slots] = randint((SP,), 30, 37)
    snap_tick = full((SP,), INF)
    snap_tick[slots] = randint((SP,), 23, 30)
    cases["scalog_cut_commit"] = (
        (
            cut_vec, commit_tick, snap_tick, full((SP,), 21),
            sc_vec_asc[0] - 1, sc_cc, sc_cc + 6, t,
        ),
        {},
    )

    # ---- Mencius vote plane, leader-major [L, W, A] (L = G stripes).
    voted = uniform((G, W, A)) < 0.3
    cases["mencius_vote"] = (
        (
            where(uniform((G, W, A)) < 0.3, randint((G, W, A), 31, 36), INF),
            voted,
            where(voted, randint((G, W, A), 30, 37), INF),
            randint((G, W, A), 1, 4),
            uniform((G, W, A)) < 0.9,
            t,
        ),
        {},
    )

    # ---- CRAQ chain plane, [N, CW] write ring + [N, L*KV] node state.
    tail = L - 1
    w_status = randint((N, CW), 0, 3).to(i8)
    cases["craq_chain"] = (
        (
            w_status,
            randint((N, CW), 0, KV),
            randint((N, CW), 0, 50),
            where(
                w_status == 2,
                randint((N, CW), 0, max(tail, 1)),
                randint((N, CW), 0, tail + 1),
            ),
            where(w_status > 0, randint((N, CW), 32, 36), INF),
            randint((N, CW), 0, 33),
            randint((N, L * KV), 0, 3),
            randint((N, L * KV), -1, 40),
            randint((N, CW), 1, 4),
            t,
        ),
        dict(tail=tail, num_keys=KV),
    )

    # ---- Compartmentalized grid-vote plane, grid-major [R, C, G, W]
    # cells + [NR, G, W] replica planes (2x2 grid, 3 replicas).
    Rg, Cg, NRg = 2, 2, 3
    cz_status = randint((G, W), 0, 3).to(i8)
    cz_head = randint((G,), 0, 50)
    cases["compartmentalized_grid_vote"] = (
        (
            clock((Rg, Cg, G, W)),  # p2a
            clock((Rg, Cg, G, W)),  # p2b
            clock((NRg, G, W)),  # rep_arrival
            cz_status,
            where(cz_status > 0, randint((G, W), 0, 33), INF),  # last_send
            cz_head[None, :] + randint((NRg, G), 0, 8),  # rep_exec
            cz_head,
            cz_head + randint((G,), 0, W + 1),
            uniform((G, W)) < 0.9,  # alive_of_pos
            uniform((Rg, Cg, G, W)) < 0.9,  # p2b_del
            uniform((Rg, Cg, G, W)) < 0.9,  # retry_del
            randint((Rg, Cg, G, W), 1, 4),  # p2b_lat
            randint((Rg, Cg, G, W), 1, 4),  # retry_lat
            randint((NRg, G, W), 1, 4),  # rep_lat
            t,
        ),
        dict(retry_timeout=8),
    )

    # ---- Dependency-graph execution plane, [B, V, VW] windowed graph
    # views (B batched graphs, V = W window vertices), sparse random
    # digraphs (average out-degree ~4).
    Bd = max(8, G // 16)
    dg_bits = uniform((Bd, W, W)) < 0.06
    cases["depgraph_execute"] = (
        (
            dgo.pack_mask(dg_bits),
            uniform((Bd, W)) < 0.5,  # committed
            uniform((Bd, W)) < 0.8,  # active
        ),
        {},
    )
    return cases


def bench_kernels(iters: int = 20, device=None, **sizes) -> List[dict]:
    """Every registered plane on the cases of :func:`kernel_cases`: its
    plain version timed, and on the card its kernel timed and checked
    against the plain outputs (``parity``). A ``KERNELS_JSON`` line
    carries the summary."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cases = kernel_cases(device=dev, **sizes)
    rows: List[dict] = []
    summary: Dict[str, dict] = {}
    for name, (args, statics) in cases.items():
        plane = registry.PLANES[name]
        ref = functools.partial(plane.reference, *args, **statics)
        want = ref()  # warm
        _sync(dev)
        ops, ref_s = _timed(_repeat(ref, iters, dev))
        rows.append(_report("kernels", f"{name}:reference", ops, ref_s))
        entry = {
            "reference_per_sec": round(iters / ref_s, 2),
            "in_bytes": _nbytes(args),
            "out_bytes": _nbytes(want),
            "parity": None,
        }
        if on_card:
            kern = functools.partial(plane.kernel, *args, **statics)
            got = kern()
            _sync(dev)
            _, kern_s = _timed(_repeat(kern, iters, dev))
            rows.append(_report("kernels", f"{name}:kernel", iters, kern_s))
            entry.update(
                parity=_tree_equal(want, got),
                kernel_per_sec=round(iters / kern_s, 2),
                speedup=round(ref_s / kern_s, 3),
            )
        summary[name] = entry
    payload = {
        "backend": dev.type,
        "device": _device_name(dev),
        "iters": iters,
        "planes": summary,
    }
    print("KERNELS_JSON " + json.dumps(payload))
    rows.append({"name": "kernels", "case": "summary", **payload})
    return rows


def _multiplane_tick(args, statics):
    """The whole-tick kernel's multi-plane twin: clock aging, the vote
    kernel, the dispatch kernel, each through device memory, on the
    ``multipaxos_fused_tick`` case args. The planes the whole-tick kernel
    replaces, so the race prices its fusion."""
    (p2a, acc_round, leader_round, slot_value, vote_round, vote_value,
     p2b, p2b_lat, delivered, head,
     status, propose_tick, last_send, chosen_tick, chosen_round,
     chosen_value, replica_arrival, next_slot, cap, retry_ok,
     send_ok, retry_deliv, p2a_lat, retry_lat, rep_lat, group_ids,
     t) = args
    p2a_aged = age_clock(p2a)
    p2b_aged = age_clock(p2b)
    vr, vv, p2b2, accr, nvotes, nsends, max_ord = mpo.fused_vote_quorum(
        p2a_aged, acc_round, leader_round, slot_value, vote_round,
        vote_value, p2b_aged, p2b_lat, delivered, head,
    )
    outs = mpo.fused_mp_dispatch(
        status, slot_value, propose_tick, last_send, chosen_tick,
        chosen_round, chosen_value, replica_arrival, p2a_aged, p2b2,
        vr, vv, nvotes, head, next_slot, leader_round, cap, retry_ok,
        send_ok, retry_deliv, p2a_lat, retry_lat, rep_lat, group_ids, t,
        f=statics["f"], retry_timeout=statics["retry_timeout"],
        num_groups=statics["num_groups"],
    )
    return (*outs, accr, nsends, max_ord)


def _race(name: str, contenders: Dict[str, Callable], iters: int,
          rounds: int, dev: torch.device, shape) -> List[dict]:
    """Check the two contenders' outputs equal, time them interleaved,
    and print the ``<NAME>_JSON`` summary line."""
    (a, fa), (b, fb) = contenders.items()
    parity = _tree_equal(fa(), fb())  # also the warm-up
    _sync(dev)
    best = _interleaved_best(contenders, iters, rounds, dev)
    rows = [_report(name, case, iters, best[case]) for case in contenders]
    payload = {
        "backend": dev.type,
        "device": _device_name(dev),
        "iters": iters,
        "rounds": rounds,
        "shape": list(shape),
        f"{a}_per_sec": round(iters / best[a], 3),
        f"{b}_per_sec": round(iters / best[b], 3),
        "speedup": round(best[b] / best[a], 3),
        "bit_identical": bool(parity),
    }
    print(f"{name.upper()}_JSON " + json.dumps(payload))
    rows.append({"name": name, "case": "summary", **payload})
    return rows


def bench_fused_tick(iters: int = 3, rounds: int = 3, device=None,
                     **sizes) -> List[dict]:
    """The whole-tick kernel against the multi-plane path it replaces
    (:func:`_multiplane_tick`), flagship shape by default: outputs checked
    bit-identical, interleaved best-of-``rounds`` timing. ``speedup`` is
    multi-plane time over whole-tick time. A ``FUSED_TICK_JSON`` line
    carries the summary."""
    dev = resolve_device(device)
    args, statics = kernel_cases(device=dev, **sizes)["multipaxos_fused_tick"]
    contenders = {
        "fused": functools.partial(mpo.fused_tick, *args, **statics),
        "multiplane": functools.partial(_multiplane_tick, args, statics),
    }
    return _race("fused_tick", contenders, iters, rounds, dev, args[0].shape)


def bench_grid_vote(iters: int = 1, rounds: int = 5, device=None,
                    **sizes) -> List[dict]:
    """The fused grid-vote kernel against its six-pass twin
    (``ops.compartmentalized.unfused_grid_vote``: aging, vote, vote
    counts, choose, replica watermark and retry, each its own kernel with
    the ``[R, C, G, W]`` planes going through device memory between
    passes), at the Compartmentalized flagship shape by default (25,000
    groups of a 2x2 grid, W = 32). ``speedup`` is six-pass time over fused
    time: the price of the round trips that the fusion deletes. A
    ``GRID_VOTE_JSON`` line carries the summary."""
    sizes.setdefault("G", 25000)
    sizes.setdefault("W", 32)
    dev = resolve_device(device)
    args, statics = kernel_cases(device=dev, **sizes)[
        "compartmentalized_grid_vote"
    ]
    contenders = {
        "fused": functools.partial(czo.fused_grid_vote, *args, **statics),
        "unfused": functools.partial(czo.unfused_grid_vote, *args, **statics),
    }
    return _race("grid_vote", contenders, iters, rounds, dev, args[0].shape)


def bench_depgraph(batch: int = 208, window: int = 64, rounds: int = 3,
                   closure_iters: int = 25, device=None) -> List[dict]:
    """The batched closure against the sequential pointer walk on the same
    random windowed graphs (the device half of the JAX package's
    ``bench_depgraph``): ``bitmask_closure`` is the plain version (Warshall
    over the whole ``[batch, window]`` brick in torch ops), ``kernel`` the
    execute kernel (on the card only), ``pointer_walk`` the host oracle
    (``ops.depgraph.oracle_execute``, an iterative Tarjan one graph at a
    time). Every side's outputs must equal the oracle's before any clock
    starts. Ops are graphs executed. A ``DEPGRAPH_JSON`` line carries the
    summary."""
    dev = resolve_device(device)
    np_rng = np.random.RandomState(0)
    bits = np_rng.random_sample((batch, window, window)) < 0.06
    adj_np = dgo.pack_mask(torch.from_numpy(bits)).numpy()
    committed = np_rng.random_sample((batch, window)) < 0.5
    active = np_rng.random_sample((batch, window)) < 0.8
    args = registry.to_torch((adj_np, committed, active), dev)

    def run_walk():
        return [
            dgo.oracle_execute(adj_np[b], committed[b], active[b])
            for b in range(batch)
        ]

    want = tuple(
        torch.from_numpy(np.stack([np.asarray(g[i]) for g in run_walk()]))
        for i in range(3)
    )
    sides = {"bitmask_closure": dgo.reference_depgraph_execute}
    if dev.type == "cuda":
        sides["kernel"] = dgo.fused_depgraph_execute
    for case, fn in sides.items():
        got = fn(*args)
        _sync(dev)
        for field, w, g in zip(dgo.DEPGRAPH_OUTS, want, got):
            if not torch.equal(w.to(g.dtype), g.cpu()):
                raise AssertionError(f"{case} != pointer_walk on {field}")

    # Per-graph best over interleaved rounds: the closure sides run
    # ``closure_iters`` batches a segment, the walk one.
    contenders = {
        case: (functools.partial(fn, *args), closure_iters)
        for case, fn in sides.items()
    }
    contenders["pointer_walk"] = (run_walk, 1)
    best: Dict[str, float] = {case: float("inf") for case in contenders}
    for _ in range(rounds):
        for case, (fn, reps) in contenders.items():
            _, seconds = _timed(_repeat(fn, reps, dev))
            best[case] = min(best[case], seconds / (reps * batch))
    rows = [
        _report("depgraph", case, reps * batch, best[case] * reps * batch)
        for case, (_, reps) in contenders.items()
    ]
    per_sec = {case: round(1.0 / best[case], 2) for case in contenders}
    payload = {
        "backend": dev.type,
        "device": _device_name(dev),
        "batch": batch,
        "window": window,
        "rounds": rounds,
        "graphs_per_sec": per_sec,
        "speedup_vs_walk": {
            case: round(best["pointer_walk"] / best[case], 3)
            for case in sides
        },
        "bit_identical": True,
    }
    print("DEPGRAPH_JSON " + json.dumps(payload))
    rows.append({"name": "depgraph", "case": "summary", **payload})
    return rows


# The port has no host data-structure benches yet (the JAX package's
# ``BENCHES``), so every bench here needs the card by default.
DEVICE_BENCHES = {
    "kernels": bench_kernels,
    "fused_tick": bench_fused_tick,
    "grid_vote": bench_grid_vote,
    "depgraph": bench_depgraph,
}


def main(argv=None) -> None:
    names = list(sys.argv[1:] if argv is None else argv) or list(DEVICE_BENCHES)
    unknown = [n for n in names if n not in DEVICE_BENCHES]
    if unknown:
        print(
            f"unknown bench(es) {', '.join(unknown)}; "
            f"choose from: {', '.join(DEVICE_BENCHES)}",
            file=sys.stderr,
        )
        sys.exit(2)
    print("name,case,ops,seconds,ops_per_sec")
    for name in names:
        DEVICE_BENCHES[name]()


if __name__ == "__main__":
    main()
