"""Multi-channel, multi-chip LoRa gateway receiver.

The reference is a single-process pipeline (one channel, one stream; its only
concurrency is the GNU Radio per-block thread scheduler — see SURVEY.md §2
"Parallelism inventory" and reference README.md:45 TODO "Decoding multiple
channels simultaneously").  Here the two scaling axes become mesh axes:

- ``ch`` (data parallel): independent frequency channels / spreading factors
  are sharded across devices and vmapped within a device.
- ``t`` (sequence parallel): the unbounded IQ stream is split into fixed
  time blocks with **overlap-save halos** — the batched analog of the reference's
  ``set_history()`` sliding windows (demod_impl.cc:130).  Each shard receives
  a left halo (enough past samples to see a packet's full preamble, so every
  shard detects a boundary packet at the same sample index) and a right halo
  (enough future samples to finish demodulating any packet that *starts* in
  its own region).  Halos move over ICI via ``lax.ppermute``.

Ownership rule: a shard keeps exactly the packets whose preamble-detection
index falls inside its own (non-halo) region — packets are decoded once,
with no cross-shard coordination beyond the two halo ppermutes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..config import LoraConfig
from ..models.demodulator import demod_fn, max_packet_symbols
from ..models.modulator import NUM_PREAMBLE_CHIRPS, packet_duration


def make_mesh(num_channel_shards: int = 1, num_time_shards: int | None = None,
              devices=None) -> Mesh:
    """Mesh over {ch, t}.  Defaults: all devices on the time axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if num_time_shards is None:
        num_time_shards = devices.size // num_channel_shards
    devices = devices.reshape(num_channel_shards, num_time_shards)
    return Mesh(devices, axis_names=("ch", "t"))


def left_halo_len(cfg: LoraConfig) -> int:
    """Past samples each time shard needs: the preamble+sync+SFD span plus
    the demodulator's own history prefill, so a packet detected near a block
    boundary is detected at the same absolute index by both shards."""
    n = cfg.num_samples
    return (NUM_PREAMBLE_CHIRPS + 2 + 3) * n  # 8 pre + 2 sync + 2.25 SFD + slack


def right_halo_len(cfg: LoraConfig) -> int:
    """Future samples each time shard needs: the longest packet span, so any
    packet that starts inside the shard's own region finishes inside its
    extended window."""
    return packet_duration(max_packet_symbols(cfg), cfg) + 2 * cfg.num_samples


class GatewayPlan(NamedTuple):
    fn: object            # jitted: iq [C, T, 2] -> (syms, lens, pos, cnt, dropped, snr)
    mesh: Mesh
    in_sharding: NamedSharding
    block_len: int        # samples per time shard (own region)
    max_packets: int      # per (channel, time-shard)


def make_gateway(cfg: LoraConfig, mesh: Mesh, num_channels: int,
                 block_len: int, max_packets: int = 8,
                 gather_results: bool = False) -> GatewayPlan:
    """Build the jitted multi-chip gateway receive step.

    Input: float32 ``iq[num_channels, nt*block_len, 2]`` sharded
    ``P('ch', 't')``.  Output (all sharded the same way):
    ``syms uint16[C, nt*max_packets, MS]``, ``lens int32[C, nt*max_packets]``,
    ``pos int32[C, nt*max_packets]`` (global sample index of detection, -1 for
    empty slots), ``cnt int32[C, nt]``, ``dropped int32[C, nt]`` (completed
    packets that overflowed a shard's ``max_packets`` slots — visible, not
    silent; the reference only prints).

    ``gather_results=True`` all-gathers the (tiny) packet outputs across the
    whole mesh so they come back fully replicated — required in multi-host
    runs (dist/multihost.py), where a process can only read the shards it
    hosts.
    """
    nt = mesh.shape["t"]
    nch = mesh.shape["ch"]
    if num_channels % nch:
        raise ValueError(f"num_channels {num_channels} % ch-shards {nch} != 0")
    lh, rh = left_halo_len(cfg), right_halo_len(cfg)
    local_t = block_len
    ext = lh + local_t + rh
    ms = max_packet_symbols(cfg)
    mp = max_packets
    demod = demod_fn(cfg, ext, mp)

    def shard_body(iq_local):
        # iq_local: [C/nch, block_len, 2] — this shard's own time region.
        t_idx = jax.lax.axis_index("t")

        # Left halo: last lh samples of the left neighbor (zeros for shard 0:
        # ppermute leaves unsourced outputs zero).
        send_right = iq_local[:, -lh:, :]
        left = jax.lax.ppermute(send_right, "t",
                                [(i, i + 1) for i in range(nt - 1)])
        # Right halo: first rh samples of the right neighbor.
        send_left = iq_local[:, :rh, :]
        right = jax.lax.ppermute(send_left, "t",
                                 [(i + 1, i) for i in range(nt - 1)])
        extended = jnp.concatenate([left, iq_local, right], axis=1)

        syms, lens, pos, cnt, dropped, snr = jax.vmap(demod)(extended)
        # Ownership: detection index inside [lh, lh + local_t).
        own = (pos >= lh) & (pos < lh + local_t)
        # Compact owned packets to the front of each channel's slot array so
        # `cnt` rows are the live ones.
        order = jnp.argsort(jnp.where(own, pos, jnp.iinfo(jnp.int32).max),
                            axis=1)
        syms = jnp.take_along_axis(syms, order[..., None], axis=1)
        lens = jnp.where(own, lens, 0)
        lens = jnp.take_along_axis(lens, order, axis=1)
        gpos = pos - lh + t_idx * local_t
        gpos = jnp.where(own, gpos, -1)
        gpos = jnp.take_along_axis(gpos, order, axis=1)
        cnt = jnp.sum(own, axis=1, dtype=jnp.int32)[:, None]
        snr = jnp.where(own, snr, 0.0)
        snr = jnp.take_along_axis(snr, order, axis=1)
        outs = (syms, lens, gpos, cnt, dropped[:, None], snr)
        if not gather_results:
            return outs

        def rep(x):
            # [c_local, S, ...] per shard -> [C, nt*S, ...] replicated.
            x = jax.lax.all_gather(x, "t", axis=1)      # [cl, nt, S, ...]
            x = jax.lax.all_gather(x, "ch", axis=0)     # [nch, cl, nt, S, .]
            s = x.shape
            return x.reshape(s[0] * s[1], s[2] * s[3], *s[4:])

        return jax.tree.map(rep, outs)

    spec = (P(None, None, None), P(None, None), P(None, None),
            P(None, None), P(None, None), P(None, None)) \
        if gather_results else \
        (P("ch", "t", None), P("ch", "t"), P("ch", "t"),
         P("ch", "t"), P("ch", "t"), P("ch", "t"))
    inner = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=P("ch", "t", None),
        out_specs=spec,
        # The demod FSM's lax.cond branches mix varying and invariant
        # constants; skip the VMA (varying-manual-axes) static check.
        check_vma=False,
    )
    fn = jax.jit(inner)
    in_sharding = NamedSharding(mesh, P("ch", "t", None))
    return GatewayPlan(fn, mesh, in_sharding, block_len, max_packets)


def gateway_receive(plan: GatewayPlan, iq: np.ndarray, cfg: LoraConfig,
                    return_stats: bool = False):
    """Host convenience: run the gateway step and collect per-channel packet
    symbol lists (uint16 arrays), position-sorted.  With ``return_stats``,
    also returns {"dropped": int} so slot overflow is observable."""
    syms, lens, pos, cnt, dropped, snr = jax.device_get(plan.fn(iq))
    out = []
    for c in range(iq.shape[0]):
        live = [(int(pos[c, r]), syms[c, r, :lens[c, r]].copy())
                for r in range(syms.shape[1]) if pos[c, r] >= 0]
        live.sort(key=lambda t: t[0])
        out.append(live)
    if return_stats:
        return out, {"dropped": int(np.sum(dropped))}
    return out
