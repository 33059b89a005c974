"""frankenpaxos_tpu_torch: the PyTorch and CUDA port of frankenpaxos_tpu.

The JAX package ``frankenpaxos_tpu`` stays the reference; this package
runs the same batched simulation in PyTorch on an NVIDIA H100, with the
hot tick planes as CUDA kernels written by hand for Hopper (``sm_90a``).
It imports nothing of JAX and nothing of the JAX package. The same
config and seed give the same State, leaf for leaf, in both packages.

Eight backends are ported: MultiPaxos (``tpu.init_state``,
``tpu.run_ticks``, ``tpu.TpuSimTransport``) and, each as
``tpu.<backend>_batched`` (``init_state``, ``run_ticks``,
``check_invariants``), Compartmentalized MultiPaxos, Mencius, Fast
MultiPaxos, Horizontal MultiPaxos, Scalog, CRAQ and BPaxos. The device
microbench is ``harness.microbench``. Entry points run on the card
unless the caller passes ``device="cpu"``: ``init_state(cfg,
device=None)`` means CUDA and raises without it.
"""

__version__ = "0.1.0"
