"""Harnesses of the port (the counterpart of ``frankenpaxos_tpu.harness``).

  * :mod:`frankenpaxos_tpu_torch.harness.microbench`: the device
    microbenchmarks: every kernel against its plain version, the
    whole-tick kernel against the planes it replaces, the fused grid vote
    against its six-pass twin, and the dependency-graph closure against
    the host pointer walk.
"""
