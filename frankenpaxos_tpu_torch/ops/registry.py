"""Kernel registry: one dispatch point for every hot protocol plane.

The counterpart of ``frankenpaxos_tpu/ops/registry.py``. Each plane pairs
a hand-written CUDA kernel (through its Python wrapper) with a plain
PyTorch version of the same function (its ``reference``), with identical
signatures and outputs.

What runs is decided by the policy and by the device of the arguments:

* ``KernelPolicy(mode="auto")`` (the default) engages every plane. The
  wrapper then launches the CUDA kernel for tensors on the card and runs
  the plain version for tensors on the CPU, which is what the CPU tests
  exercise.
* ``KernelPolicy(mode="reference")``, or a plane named in ``disable``,
  routes that plane to the plain version. On the card that raises: the
  plain versions never stand in for a kernel on the main path.

``disable=("multipaxos_fused_tick",)`` therefore runs the tick as the
two per-plane kernels instead of the whole-tick kernel.

Every wrapper adds one to ``LAUNCHES[plane]`` where it launches its
kernel, and nowhere else; a kernel with more than one route (the
phase-1, grid-vote, horizontal vote, CRAQ chain, Mencius vote and Fast
MultiPaxos vote kernels: vector, scalar, general) also adds one to
``ROUTE_LAUNCHES[plane][route]``. ``reset_launches`` zeroes the counts. The
JAX package's autotune table, ``shard_lowering`` and cost-model hooks
have no counterpart yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """The per-config kernel knob (frozen and hashable: it lives in the
    static backend config).

    ``mode``: "auto" | "reference". ``block``: groups per CUDA thread
    block (0 = the kernel's own choice). ``disable``: plane names forced
    to the plain version."""

    mode: str = "auto"
    block: int = 0
    disable: Tuple[str, ...] = ()

    MODES = ("auto", "reference")

    def validate(self) -> None:
        if self.mode not in self.MODES:
            raise NotImplementedError(
                f"kernels.mode={self.mode!r}: the port has the modes "
                f"{self.MODES} (the JAX package's interpret mode has no "
                f"counterpart)"
            )
        if self.block < 0:
            raise ValueError("kernels.block must be >= 0")
        for name in self.disable:
            if name not in PLANES:
                raise ValueError(
                    f"kernels.disable names unknown plane {name!r}; "
                    f"registered: {sorted(PLANES)}"
                )

    @classmethod
    def reference(cls) -> "KernelPolicy":
        return cls(mode="reference")


@dataclasses.dataclass(frozen=True)
class Plane:
    """One registered protocol plane: a kernel wrapper and its plain
    PyTorch version (identical signatures and outputs)."""

    name: str
    backend: str  # which tpu/*_batched.py module owns the plane
    reference: Callable
    kernel: Callable  # (*args, block=int, **statics)
    source: str  # the CUDA source of the kernel, relative to the package
    replaces: str  # the Pallas kernel it replaces (file:line function)


PLANES: Dict[str, Plane] = {}

# Kernel launches per plane (plain ints; plain-version runs never count).
LAUNCHES: Dict[str, int] = {}
# Kernel launches per route, for the kernels that take more than one:
# {plane: {route: launches}}.
ROUTE_LAUNCHES: Dict[str, Dict[str, int]] = {}
# Those kernels' routes, in the order of their launchers' route codes
# (the `Route` enums of csrc/multipaxos.cu, horizontal.cu, craq.cu,
# mencius.cu and fastmultipaxos.cu; csrc/compartmentalized.cu
# fpx_cz_launch).
ROUTES = ("scalar", "general", "vector")


def register(plane: Plane) -> Plane:
    assert plane.name not in PLANES, f"duplicate plane {plane.name}"
    PLANES[plane.name] = plane
    LAUNCHES[plane.name] = 0
    return plane


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ROUTE_LAUNCHES.clear()


def count_launch(name: str, route: str = "") -> None:
    LAUNCHES[name] += 1
    if route:
        routes = ROUTE_LAUNCHES.setdefault(name, {})
        routes[route] = routes.get(route, 0) + 1


def coverage() -> Dict[str, Tuple[str, ...]]:
    """backend -> registered plane names."""
    out: Dict[str, list] = {}
    for plane in PLANES.values():
        out.setdefault(plane.backend, []).append(plane.name)
    return {k: tuple(sorted(v)) for k, v in sorted(out.items())}


def policy_of(cfg) -> KernelPolicy:
    pol = getattr(cfg, "kernels", None)
    return KernelPolicy() if pol is None else pol


def resolve_mode(name: str, cfg) -> str:
    """'kernel' | 'reference' for this (plane, config). 'kernel' means
    the wrapper runs: the CUDA kernel on the card, the plain version on
    the CPU."""
    pol = policy_of(cfg)
    if pol.mode == "reference" or name in pol.disable:
        return "reference"
    return "kernel"


def on_cpu(tensors: Sequence[torch.Tensor]) -> bool:
    """True when every tensor lies on the CPU (a wrapper runs the plain
    version), False when every one lies on one CUDA device (it launches
    its kernel); anything else raises."""
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"plane tensors span several devices: {devices}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {dev}")


def aligned16(tensors) -> bool:
    """True when every tensor's data starts on a 16-byte boundary (the
    vector routes' loads and stores are 16 bytes wide)."""
    return all(
        x.data_ptr() % 16 == 0 for x in tensors if isinstance(x, torch.Tensor)
    )


def misaligned(args) -> tuple:
    """Each tensor of ``args`` copied into a contiguous view one element
    past a 16-byte boundary (the vector routes refuse it); other
    arguments pass."""
    out = []
    for x in args:
        if isinstance(x, torch.Tensor):
            flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
            x = flat[1:].view(x.shape).copy_(x)
        out.append(x)
    return tuple(out)


def to_torch(args, device) -> tuple:
    """numpy arrays to tensors on ``device``; Python scalars pass."""
    return tuple(
        torch.from_numpy(np.array(a, order="C", copy=True)).to(device)
        if isinstance(a, np.ndarray)
        else a
        for a in args
    )


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise ValueError("a plane call needs at least one tensor argument")


def dispatch(name: str, cfg, *args, **statics):
    """Run one protocol plane under the config's policy (module
    docstring). ``args`` are the plane's tensors, ``statics`` its
    scalars."""
    plane = PLANES[name]
    if resolve_mode(name, cfg) == "kernel":
        return plane.kernel(*args, block=policy_of(cfg).block, **statics)
    device = _device_of(args)
    if device.type != "cpu":
        raise RuntimeError(
            f"plane {name!r} resolves to its plain version under "
            f"{policy_of(cfg)}, but its tensors lie on {device}: the "
            f"plain versions never stand in for a kernel off the CPU"
        )
    return plane.reference(*args, **statics)
