"""Build and load the port's CUDA kernels.

The kernels live in ``frankenpaxos_tpu_torch/csrc/*.cu`` with a plain C
interface. At first use :func:`load` compiles them with ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together), links the
objects into one shared library and loads it with ``ctypes`` (a few
seconds; a build through ``torch.utils.cpp_extension`` would include
PyTorch's headers and take minutes). The library's name carries a hash
of the sources, headers and flags, so an edited source is rebuilt and a
stale library is never loaded.

The build directory is ``build/cuda`` at the root of the checkout
(listed in ``.gitignore``), or ``$FPX_TORCH_BUILD_DIR``. Nothing is
imported or compiled when this module is imported: the CPU tests import
every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
SOURCES = (
    "multipaxos.cu", "compartmentalized.cu", "mencius.cu", "fastmultipaxos.cu",
    "horizontal.cu", "scalog.cu", "craq.cu", "depgraph.cu",
)
HEADERS = ("common.cuh",)

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
# (entry-point prefix, pointer slots) pairs whose layout was checked.
_CHECKED: set = set()

# Seconds the last build took (0.0 when a built library was reused) and
# the compiler's report (registers, shared memory, spills per kernel).
BUILD_SECONDS = 0.0
BUILD_LOG = ""


def build_dir() -> str:
    return os.environ.get(
        "FPX_TORCH_BUILD_DIR",
        os.path.join(os.path.dirname(_PKG_DIR), "build", "cuda"),
    )


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run(cmds) -> str:
    """Run the commands in parallel; raise if any fails. Returns their
    joined output (the compiler's register and spill report)."""
    procs = [
        subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        for cmd in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    for cmd, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (rc={p.returncode}):\n{' '.join(cmd)}\n{o}"
            )
    return log


def _compile(target: str) -> None:
    global BUILD_SECONDS, BUILD_LOG
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}"
    nvcc = nvcc_path()
    objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
    t0 = time.perf_counter()
    log = _run([
        [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, src)]
        for src, obj in zip(SOURCES, objs)
    ])
    log += _run([[nvcc, "-shared", "-o", f"{tmp}.tmp", *objs]])
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = log
    os.replace(f"{tmp}.tmp", target)
    for obj in objs:
        os.remove(obj)
    with open(target + ".log", "w") as f:
        f.write(BUILD_LOG)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        target = os.path.join(build_dir(), f"libfpx_kernels_{_digest()}.so")
        if not os.path.exists(target):
            _compile(target)
        lib = ctypes.CDLL(target)
        lib.fpx_mp_num_slots.restype = ctypes.c_int
        lib.fpx_mp_num_slots.argtypes = []
        lib.fpx_mp_launch.restype = ctypes.c_int
        lib.fpx_mp_launch.argtypes = [
            ctypes.c_int,  # which
            ctypes.c_int,  # A
            ctypes.POINTER(ctypes.c_void_p),  # ptrs
            ctypes.POINTER(ctypes.c_int),  # ints
            ctypes.c_void_p,  # stream
        ]
        lib.fpx_czu_num_slots.restype = ctypes.c_int
        lib.fpx_czu_num_slots.argtypes = []
        lib.fpx_czu_launch.restype = ctypes.c_int
        lib.fpx_czu_launch.argtypes = [
            ctypes.c_int,  # which pass
            ctypes.POINTER(ctypes.c_void_p),  # ptrs
            ctypes.POINTER(ctypes.c_int),  # ints
            ctypes.c_void_p,  # stream
        ]
        for name in (
            "fpx_cz", "fpx_mencius", "fpx_fmp", "fpx_horizontal", "fpx_scalog",
            "fpx_craq", "fpx_depgraph",
        ):
            getattr(lib, f"{name}_num_slots").restype = ctypes.c_int
            getattr(lib, f"{name}_num_slots").argtypes = []
            getattr(lib, f"{name}_launch").restype = ctypes.c_int
            getattr(lib, f"{name}_launch").argtypes = [
                ctypes.POINTER(ctypes.c_void_p),  # ptrs
                ctypes.POINTER(ctypes.c_int),  # ints
                ctypes.c_void_p,  # stream
            ]
        lib.fpx_scalog_floor_launch.restype = ctypes.c_int
        lib.fpx_scalog_floor_launch.argtypes = lib.fpx_scalog_launch.argtypes
        lib.fpx_error_string.restype = ctypes.c_char_p
        lib.fpx_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
        return lib


def kernel_lib(prefix: str, num_slots: int) -> ctypes.CDLL:
    """:func:`load`, after checking once that the kernel behind
    ``<prefix>_launch`` takes ``num_slots`` pointer slots (the wrapper's
    argument layout)."""
    lib = load()
    if (prefix, num_slots) not in _CHECKED:
        have = getattr(lib, f"{prefix}_num_slots")()
        if have != num_slots:
            raise RuntimeError(
                f"{prefix}: the CUDA library takes {have} pointer slots, the "
                f"wrapper fills {num_slots}"
            )
        _CHECKED.add((prefix, num_slots))
    return lib
