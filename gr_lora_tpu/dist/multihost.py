"""Multi-host distribution: the gateway spanning processes over DCN.

The reference is strictly single-process (SURVEY.md §2 "Distributed comm
backend: none"); BASELINE.md's north star shards the IQ stream's time axis
over >= 2 hosts.  This module is that runtime:

- ``initialize()`` wraps ``jax.distributed.initialize`` (coordinator
  rendezvous; CPU processes use Gloo, GPUs NCCL) so
  every process sees the GLOBAL device list.
- ``make_multihost_mesh()`` arranges the global devices into the gateway's
  ``{ch, t}`` grid.  Device order from ``jax.devices()`` groups processes
  contiguously, so with the channel axis slowest, ``ch`` never crosses a
  process boundary (channels are comm-free) while consecutive ``t`` shards
  are intra-process except one DCN hop per process seam — exactly where the
  overlap-save halo ppermute (dist/gateway.py) pays its single exchange.
- ``process_local_input()`` builds the global sharded array from each
  process's own slice of the stream (no host ever holds the full capture).
- Use ``make_gateway(..., gather_results=True)`` so the (tiny) packet
  outputs come back fully replicated and every process can read them.

Validated end-to-end by tests/test_multihost.py: two OS processes, a
packet straddling the process seam, identical PDU sets on both sides.
"""

from __future__ import annotations

import numpy as np
from jax.sharding import Mesh

from ..config import LoraConfig
from .gateway import GatewayPlan


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, platform: str | None = None) -> None:
    """Join the distributed runtime.  Call before any other jax use.

    For CPU validation runs set ``platform='cpu'`` (forces the config knob
    whatever the environment says) and set
    ``XLA_FLAGS=--xla_force_host_platform_device_count=N`` per process.
    """
    import jax

    if platform is not None:
        jax.config.update("jax_platforms", platform)
    jax.distributed.initialize(coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_multihost_mesh(num_channel_shards: int = 1,
                        num_time_shards: int | None = None) -> Mesh:
    """{ch, t} mesh over the GLOBAL device list (see module docstring for
    the DCN-aware layout rationale)."""
    import jax

    devices = np.asarray(jax.devices())
    if num_time_shards is None:
        num_time_shards = devices.size // num_channel_shards
    devices = devices.reshape(num_channel_shards, num_time_shards)
    return Mesh(devices, axis_names=("ch", "t"))


def time_range_of_process(plan: GatewayPlan, total_len: int) -> tuple[int, int]:
    """[start, end) sample range of the time shards this process hosts.

    Each process feeds only its own range into ``process_local_input`` —
    the stream is never materialized on one host.
    """
    import jax

    mesh = plan.mesh
    nt = mesh.shape["t"]
    block = total_len // nt
    t_axis = mesh.axis_names.index("t")
    my = [idx[t_axis] for idx, d in np.ndenumerate(mesh.devices)
          if d.process_index == jax.process_index()]
    lo, hi = min(my), max(my) + 1
    assert set(my) == set(range(lo, hi)), \
        "process's time shards must be contiguous (use make_multihost_mesh)"
    return lo * block, hi * block


def process_local_input(plan: GatewayPlan, iq_local: np.ndarray,
                        total_len: int):
    """Assemble the global [C, total_len, 2] sharded input from this
    process's own time slice (shape [C, local_len, 2])."""
    import jax

    c = iq_local.shape[0]
    return jax.make_array_from_process_local_data(
        plan.in_sharding, np.ascontiguousarray(iq_local, np.float32),
        (c, total_len, 2))


def multihost_gateway_receive(plan: GatewayPlan, global_iq,
                              cfg: LoraConfig):
    """Run the gateway step; requires a plan built with
    ``gather_results=True`` so outputs are replicated.  Returns the same
    per-channel (position, symbols) lists as gateway_receive on every
    process."""
    from .gateway import gateway_receive

    return gateway_receive(plan, global_iq, cfg, return_stats=True)
