"""Device-resident sample ring: the gateway's stream buffer lives in
device memory.

The detection-gated gateways (dist/collision_gateway, dist/triggered)
would otherwise keep their stream buffer on the host and re-upload every
scan chunk and every dispatched window: one 64-channel x 1 Msample feed
would cross the host link ~6x (once per SF) plus once more per dispatched
window.  The principle is the one the reference applies to its own ring
(`lib/` SPSC buffering): samples cross the host link exactly once.

`DeviceRing` holds a contiguous live span inside a fixed [C, cap, 2]
float32 HBM buffer.  Appends, chunk slices and per-event window gathers
are jitted device ops whose offsets are *traced* scalars — fixed shapes,
so the jit cache stays warm no matter where the stream pointer is.  The
live span is compacted (one on-device roll) only when an append would run
off the end, and the buffer grows geometrically if a feed outsizes it.

Coordinates are the caller's absolute sample indices minus the span start
(the gateway's `_base` bookkeeping maps 1:1).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["DeviceRing"]


@jax.jit
def _append(buf, chunk, start):
    return jax.lax.dynamic_update_slice(buf, chunk, (0, start, 0))


@jax.jit
def _compact(buf, shift):
    return jnp.roll(buf, -shift, axis=1)


@partial(jax.jit, static_argnums=1)
def _grow(buf, newcap):
    # Pad along the time axis: sharding (if any) propagates from buf.
    return jnp.pad(buf, ((0, 0), (0, newcap - buf.shape[1]), (0, 0)))


@partial(jax.jit, static_argnums=2)
def _slice(buf, start, size):
    return jax.lax.dynamic_slice(
        buf, (0, start, 0), (buf.shape[0], size, buf.shape[2]))


@partial(jax.jit, static_argnums=3)
def _gather(buf, chs, starts, size):
    def one(ch, s):
        w = jax.lax.dynamic_slice(buf, (ch, s, 0),
                                  (1, size, buf.shape[2]))
        return w[0]

    return jax.vmap(one)(chs, starts)


class DeviceRing:
    """Contiguous device-resident window of a multi-channel sample stream.

    ``history`` pre-fills that many zero samples so reads up to `history`
    before the first appended sample are well-defined (the gateways' window
    lead at stream start).  Offsets passed to :meth:`slice` / :meth:`gather`
    are relative to that zero history's start.
    """

    def __init__(self, channels: int, cap: int, history: int = 0,
                 width: int = 2, sharding=None):
        self.channels = channels
        self.width = width
        self.cap = max(1 << int(np.ceil(np.log2(max(cap, 1024)))), 1024)
        #: Optional NamedSharding (P('ch', None, None)): the buffer — and
        #: every append/slice/gather — is channel-sharded over the mesh.
        #: Multi-controller safe: the buffer is created inside jit and all
        #: ops run on global arrays.
        self._sharding = sharding
        self._buf = self._zeros((channels, self.cap, width))
        self._off = 0              # ring coord of live-span start
        self.length = history      # live span length (incl. zero history)
        #: Host->device bytes actually moved by :meth:`append` (device-
        #: resident inputs are copied HBM->HBM and do not count).
        self.ingest_bytes = 0

    def _zeros(self, shape):
        if self._sharding is None:
            return jnp.zeros(shape, jnp.float32)
        return jax.jit(partial(jnp.zeros, shape, jnp.float32),
                       out_shardings=self._sharding)()

    def _ensure(self, extra: int):
        need = self.length + extra
        if need > self.cap:                       # grow (rare)
            newcap = 1 << int(np.ceil(np.log2(need + (need >> 2))))
            if self._off:
                self._buf = _compact(self._buf, self._off)
                self._off = 0
            self._buf = _grow(self._buf, newcap)
            self.cap = newcap
        elif self._off + need > self.cap:         # compact in place
            self._buf = _compact(self._buf, self._off)
            self._off = 0

    def append(self, chunk) -> None:
        """chunk [C, L, width]: host ndarray (uploaded once; in the
        sharded multi-controller layout every process passes the full
        matrix and transfers only its own shards) or device array
        (HBM->HBM, no link traffic)."""
        if isinstance(chunk, np.ndarray):
            self.ingest_bytes += chunk.nbytes
            chunk = np.asarray(chunk, np.float32)
            if self._sharding is not None:
                chunk = jax.make_array_from_callback(
                    chunk.shape, self._sharding,
                    lambda idx, c=chunk: c[idx])
        chunk = jnp.asarray(chunk, jnp.float32)
        if (self._sharding is not None and jax.process_count() == 1
                and chunk.sharding != self._sharding):
            chunk = jax.device_put(chunk, self._sharding)
        assert chunk.shape[0] == self.channels, chunk.shape
        lg = int(chunk.shape[1])
        self._ensure(lg)
        self._buf = _append(self._buf, chunk, self._off + self.length)
        self.length += lg

    def trim(self, cut: int) -> None:
        """Logically drop the oldest `cut` samples (no device work; the
        space is reclaimed by the next overflow compaction)."""
        assert 0 <= cut <= self.length, (cut, self.length)
        self._off += cut
        self.length -= cut

    def sync(self) -> None:
        """Block until pending appends have executed (tiny fetch; used to
        attribute upload time to the caller's ingest wall)."""
        if self._sharding is not None:
            # Shard [0, 0] may live on a remote process; a local barrier
            # is what 'upload done' means here.
            self._buf.block_until_ready()
        else:
            jax.device_get(self._buf[0, 0])

    def slice(self, lo: int, size: int):
        """Device [C, size, width] of span offsets [lo, lo+size)."""
        assert 0 <= lo and lo + size <= self.length, (lo, size, self.length)
        return _slice(self._buf, self._off + lo, size)

    def gather(self, chs, los, size: int):
        """Device [E, size, width] windows at (channel, span offset) pairs.
        Each window must lie inside the live span."""
        chs = np.asarray(chs, np.int32)
        los = np.asarray(los, np.int64)
        assert np.all(los >= 0) and np.all(los + size <= self.length), \
            (los, size, self.length)
        return _gather(self._buf, jnp.asarray(chs),
                       jnp.asarray((los + self._off).astype(np.int32)), size)
