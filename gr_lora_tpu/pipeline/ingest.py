"""Threaded streaming ingest: producer -> native SPSC ring -> device blocks.

The GNU Radio runtime connects blocks through lock-free ring buffers with
one thread per block (SURVEY.md §1 host-framework row).  This is that
runtime service for the device pipeline:

- a **producer thread** reads raw complex64 bytes from any file-like source
  (file, fifo, stdin, socket) into the native SPSC ring
  (native/src/ring_buffer.cc — acquire/release atomics, no locks);
- the **consumer** (caller thread) drains fixed-size sample blocks and hands
  them to a block consumer such as ``StreamingDemodulator(pipelined=True)``
  or ``StreamingPyramidDemodulator``, so the host->device copy and jit
  dispatch of block i+1 overlap the device work of block i.

Backpressure is the ring itself: a full ring stalls the producer (bounded
memory), an empty ring parks the consumer on a condition-free sleep spin
with exponential backoff (latency << one block of air time).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterator

import numpy as np

ITEM = 8  # complex64 bytes per sample


class RingIngest:
    """Producer-thread ingest into the native ring; iterate sample blocks.

    ``block_samples`` is the consumer granularity; ``capacity_blocks`` sizes
    the ring (bounded memory, GR-buffer analog).  The source is any object
    with ``read(nbytes) -> bytes`` (b"" = EOF) or ``readinto(memoryview)``.
    """

    def __init__(self, source, block_samples: int,
                 capacity_blocks: int = 4, read_chunk: int = 1 << 16):
        from .. import native

        assert native.available(), "native library required for ring ingest"
        self.block_samples = block_samples
        self._ring = native.RingBuffer(capacity_blocks * block_samples * ITEM)
        self._source = source
        self._read_chunk = read_chunk
        self._eof = threading.Event()
        self._stop = threading.Event()   # consumer gone: stop producing
        self._err: list[BaseException] = []
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._started = False
        #: bytes dropped because the trailing read was not a whole sample
        self.trailing_bytes = 0

    # -- producer thread --------------------------------------------------
    def _produce(self):
        try:
            residue = b""
            while not self._stop.is_set():
                data = self._source.read(self._read_chunk)
                if not data:
                    break
                data = residue + data
                usable = len(data) - (len(data) % ITEM)
                residue = data[usable:]
                view = np.frombuffer(data[:usable], np.uint8)
                off = 0
                while off < len(view):
                    wrote = self._ring.write(view[off:])
                    if wrote == 0:
                        # Ring full: backpressure — unless the consumer is
                        # gone (close()/consumer exception), in which case
                        # spinning forever just burns a CPU core.
                        if self._stop.is_set():
                            return
                        time.sleep(1e-4)
                    off += wrote
            self.trailing_bytes = len(residue)
        except BaseException as e:          # surfaced on the consumer side
            self._err.append(e)
        finally:
            self._eof.set()

    # -- consumer side ----------------------------------------------------
    def start(self) -> "RingIngest":
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def close(self) -> None:
        """Release the producer thread (it exits its backpressure loop)."""
        self._stop.set()

    def blocks(self) -> Iterator[np.ndarray]:
        """Yield float32 [block_samples, 2] blocks until EOF; the final
        partial block (if any) is yielded zero-padded to full size with its
        true length knowable from ``last_block_samples``."""
        self.start()
        want = self.block_samples * ITEM
        backoff = 1e-5
        self.last_block_samples = self.block_samples
        try:
            while True:
                if self._ring.readable >= want:
                    raw = self._ring.read(want)
                    backoff = 1e-5
                    yield raw.view(np.float32).reshape(-1, 2)
                    continue
                if self._eof.is_set():
                    # EOF can land between the readable check and here with
                    # up to capacity_blocks of data still in the ring: drain
                    # every remaining FULL block before the partial-tail
                    # epilogue.
                    while self._ring.readable >= want:
                        yield self._ring.read(want) \
                            .view(np.float32).reshape(-1, 2)
                    break
                time.sleep(backoff)
                backoff = min(backoff * 2, 1e-3)
        except BaseException:
            # Consumer died (or closed the generator): unblock the producer
            # so it doesn't spin on a full ring forever.
            self.close()
            raise
        if self._err:
            raise self._err[0]
        left = self._ring.readable - (self._ring.readable % ITEM)
        if left:
            raw = self._ring.read(left)
            samples = left // ITEM
            self.last_block_samples = samples
            pad = np.zeros(want, np.uint8)
            pad[:left] = raw
            yield pad.view(np.float32).reshape(-1, 2)


def stream_demodulate(cfg, source, on_packet: Callable | None = None,
                      block_len: int | None = None, max_packets: int = 8,
                      capacity_blocks: int = 4):
    """File-like complex64 source -> packets via the threaded ring +
    pipelined StreamingDemodulator.  Returns the full (position, symbols)
    list; ``on_packet(pos, syms)`` fires as packets complete."""
    from ..models.demodulator import StreamingDemodulator

    sd = StreamingDemodulator(cfg, block_len=block_len,
                              max_packets=max_packets, pipelined=True)
    ingest = RingIngest(source, sd.block_len, capacity_blocks)
    out: list[tuple[int, np.ndarray]] = []

    def emit(pkts):
        for pos, syms in pkts:
            out.append((pos, syms))
            if on_packet is not None:
                on_packet(pos, syms)

    for block in ingest.blocks():
        emit(sd.feed(block))
    emit(sd.flush())
    return out
