"""The kernel layer of the port (the counterpart of
``frankenpaxos_tpu.ops``).

  * :mod:`frankenpaxos_tpu_torch.ops.registry`: the
    :class:`KernelPolicy` knob, the plane registry, per-plane launch
    counts and :func:`dispatch`.
  * :mod:`frankenpaxos_tpu_torch.ops.multipaxos`: the MultiPaxos tick
    planes, each a hand-written CUDA kernel for Hopper
    (``csrc/multipaxos.cu``) beside its plain PyTorch version.
  * :mod:`frankenpaxos_tpu_torch.ops.compartmentalized`: the
    Compartmentalized MultiPaxos acceptor-grid plane, a hand-written CUDA
    kernel for Hopper (``csrc/compartmentalized.cu``) beside its plain
    PyTorch version, and its six-pass twin (six kernels beside six plain
    passes), the race baseline of the microbench.
  * :mod:`frankenpaxos_tpu_torch.ops.mencius` and
    :mod:`frankenpaxos_tpu_torch.ops.fastmultipaxos`: the Mencius and
    Fast MultiPaxos vote planes, each a hand-written CUDA kernel for
    Hopper (``csrc/mencius.cu``, ``csrc/fastmultipaxos.cu``) beside its
    plain PyTorch version.
  * :mod:`frankenpaxos_tpu_torch.ops.horizontal` and
    :mod:`frankenpaxos_tpu_torch.ops.scalog`: the Horizontal MultiPaxos
    vote plane and the Scalog cut-commit plane, each a hand-written CUDA
    kernel for Hopper (``csrc/horizontal.cu``, ``csrc/scalog.cu``) beside
    its plain PyTorch version.
  * :mod:`frankenpaxos_tpu_torch.ops.craq` and
    :mod:`frankenpaxos_tpu_torch.ops.depgraph`: the CRAQ chain plane and
    the dependency-graph execute plane (with the packed-word helpers and
    the host oracle), each a hand-written CUDA kernel for Hopper
    (``csrc/craq.cu``, ``csrc/depgraph.cu``) beside its plain PyTorch
    version.
  * :mod:`frankenpaxos_tpu_torch.ops._build`: builds the CUDA sources
    with ``nvcc`` at first use and loads them with ``ctypes``.
"""

from frankenpaxos_tpu_torch.tpu.common import INF, INF16  # noqa: F401

from frankenpaxos_tpu_torch.ops import registry  # noqa: F401
from frankenpaxos_tpu_torch.ops.registry import (  # noqa: F401
    KernelPolicy,
    coverage,
    dispatch,
)
from frankenpaxos_tpu_torch.ops.multipaxos import (  # noqa: F401
    fused_mp_dispatch,
    fused_tick,
    fused_vote_quorum,
    reference_fused_tick,
    reference_mp_dispatch,
    reference_vote_quorum,
)
from frankenpaxos_tpu_torch.ops.compartmentalized import (  # noqa: F401
    fused_grid_vote,
    reference_grid_vote,
    reference_unfused_grid_vote,
    unfused_grid_vote,
)
from frankenpaxos_tpu_torch.ops.mencius import (  # noqa: F401
    fused_mencius_vote,
    reference_mencius_vote,
)
from frankenpaxos_tpu_torch.ops.fastmultipaxos import (  # noqa: F401
    fused_fmp_vote,
    reference_fmp_vote,
)
from frankenpaxos_tpu_torch.ops.horizontal import (  # noqa: F401
    fused_horizontal_vote,
    reference_horizontal_vote,
)
from frankenpaxos_tpu_torch.ops.scalog import (  # noqa: F401
    fused_scalog_cut_commit,
    reference_scalog_cut_commit,
)
from frankenpaxos_tpu_torch.ops.craq import (  # noqa: F401
    fused_craq_chain,
    reference_craq_chain,
)
from frankenpaxos_tpu_torch.ops.depgraph import (  # noqa: F401
    fused_depgraph_execute,
    reference_depgraph_execute,
)
