"""The port's device microbench (``frankenpaxos_tpu_torch.harness.
microbench``) on the CPU: its kernel cases equal the JAX package's
``_kernel_cases`` leaf for leaf, each kernel wrapper's checks accept
them, every bench runs and reports its two sides bit-identical, the CLI
refuses an unknown bench, and the entry points refuse to run without a
card unless the caller asks for the CPU."""

import json

import jax
import numpy as np
import pytest
import torch

from frankenpaxos_tpu.harness import microbench as jmb
from frankenpaxos_tpu_torch.harness import microbench as tmb
from frankenpaxos_tpu_torch.ops import compartmentalized as tcz
from frankenpaxos_tpu_torch.ops import craq as tcr
from frankenpaxos_tpu_torch.ops import depgraph as tdg
from frankenpaxos_tpu_torch.ops import fastmultipaxos as tfmp
from frankenpaxos_tpu_torch.ops import horizontal as thz
from frankenpaxos_tpu_torch.ops import mencius as tmen
from frankenpaxos_tpu_torch.ops import multipaxos as tmp
from frankenpaxos_tpu_torch.ops import registry
from frankenpaxos_tpu_torch.ops import scalog as tsc

SIZES = dict(A=3, G=32, W=16, N=32, L=3, KV=4, CW=8)


@pytest.fixture(scope="module")
def jax_cases():
    """JAX's ``_kernel_cases`` at SIZES, compiled as one program (the
    arrays are those of the eager call; one compile instead of one per
    draw). Returns ``{plane: (args, statics)}``."""
    statics = {}

    def build():
        cases = jmb._kernel_cases(**SIZES)
        statics.update({name: st for name, (_, st) in cases.items()})
        return {name: args for name, (args, _) in cases.items()}

    args = jax.jit(build)()
    return {name: (args[name], statics[name]) for name in statics}


def _leaf_equal(j, p) -> bool:
    """A JAX leaf against the port's: the tick is a Python int in the
    port (an int32 scalar in JAX), and packed words are int32 in the port
    (the bits of JAX's uint32)."""
    j = np.asarray(j)
    if isinstance(p, int):
        return j.dtype == np.int32 and j.shape == () and int(j) == p
    p = p.numpy()
    if j.dtype == np.uint32:
        j = j.view(np.int32)
    return j.dtype == p.dtype and j.shape == p.shape and np.array_equal(j, p)


def test_kernel_cases_equal_jax(jax_cases):
    port = tmb.kernel_cases(device="cpu", **SIZES)
    assert list(port) == list(jax_cases)
    assert set(port) == set(registry.PLANES)
    for name, (jargs, jstatics) in jax_cases.items():
        pargs, pstatics = port[name]
        assert pstatics == jstatics, name
        assert len(pargs) == len(jargs), name
        for i, (j, p) in enumerate(zip(jargs, pargs)):
            assert _leaf_equal(j, p), f"{name} argument {i}"


_MODULES = {
    "compartmentalized_grid_vote": tcz, "mencius_vote": tmen,
    "fastmultipaxos_vote": tfmp, "horizontal_vote": thz,
    "scalog_cut_commit": tsc, "craq_chain": tcr, "depgraph_execute": tdg,
}


def test_kernel_cases_pass_the_kernel_checks():
    """Every case is one the card's kernel takes: each wrapper's checks
    (shapes, dtypes, contiguity) run before the CUDA library loads, so
    they run here; the outputs they allocate match the plain version's."""
    for name, (args, statics) in tmb.kernel_cases(device="cpu", **SIZES).items():
        if name.startswith("multipaxos_"):
            _, outs = tmp.prepared_launch(name, *args, **statics)
        else:
            _, outs = _MODULES[name].prepared_launch(*args, **statics)
        plain = registry.PLANES[name].reference(*args, **statics)
        assert [(o.shape, o.dtype) for o in outs] == [
            (o.shape, o.dtype) for o in plain
        ], name


def test_tree_equal():
    a = (torch.arange(4, dtype=torch.int32), (torch.zeros(2, dtype=torch.bool),))
    assert tmb._tree_equal(a, (a[0].clone(), (a[1][0].clone(),)))
    assert not tmb._tree_equal(a, (a[0].to(torch.int64), a[1]))
    assert not tmb._tree_equal(a, (a[0] + 1, a[1]))
    assert not tmb._tree_equal(a, (a[0],))


def test_bench_kernels_cpu(capsys):
    rows = tmb.bench_kernels(iters=1, device="cpu", **SIZES)
    assert [r["case"] for r in rows] == [
        f"{name}:reference" for name in tmb.kernel_cases(device="cpu", **SIZES)
    ] + ["summary"]
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("KERNELS_JSON ")]
    assert len(line) == 1
    payload = json.loads(line[0].split(" ", 1)[1])
    assert rows[-1] == {"name": "kernels", "case": "summary", **payload}
    assert payload["backend"] == "cpu"
    assert set(payload["planes"]) == set(registry.PLANES)
    for entry in payload["planes"].values():
        assert entry["parity"] is None
        assert entry["in_bytes"] > 0 and entry["out_bytes"] > 0


@pytest.mark.parametrize("bench, sides", [
    ("fused_tick", ("fused", "multiplane")),
    ("grid_vote", ("fused", "unfused")),
])
def test_races_cpu(bench, sides):
    rows = tmb.DEVICE_BENCHES[bench](iters=1, rounds=2, device="cpu", **SIZES)
    assert [r["case"] for r in rows] == [*sides, "summary"]
    summary = rows[-1]
    assert summary["bit_identical"] is True
    assert summary["backend"] == "cpu"
    for side in sides:
        assert summary[f"{side}_per_sec"] > 0
    assert summary["speedup"] > 0


def test_grid_vote_defaults_to_the_compartmentalized_shape():
    rows = tmb.bench_grid_vote(iters=1, rounds=1, device="cpu", G=5, A=3)
    assert rows[-1]["shape"] == [2, 2, 5, 32]
    assert rows[-1]["bit_identical"] is True


def test_bench_depgraph_cpu():
    rows = tmb.bench_depgraph(
        batch=8, window=16, rounds=1, closure_iters=2, device="cpu"
    )
    assert [r["case"] for r in rows] == [
        "bitmask_closure", "pointer_walk", "summary",
    ]
    assert rows[-1]["bit_identical"] is True
    assert set(rows[-1]["graphs_per_sec"]) == {"bitmask_closure", "pointer_walk"}


def test_main_refuses_unknown_bench(capsys):
    with pytest.raises(SystemExit) as exc:
        tmb.main(["kernels", "no_such_bench"])
    assert exc.value.code == 2
    assert "no_such_bench" in capsys.readouterr().err


@pytest.mark.parametrize("bench", sorted(tmb.DEVICE_BENCHES))
def test_entry_points_need_a_card_unless_asked(bench):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmb.DEVICE_BENCHES[bench]()
