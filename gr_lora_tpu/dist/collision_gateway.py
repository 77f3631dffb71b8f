"""Detection-gated gateway-scale collision decoding: channels x SF7-12.

The BASELINE.md north-star (64 x 125 kHz channels, every SF, Pyramid
collision decoding on each cell) cannot be an always-on dense lattice: the
pyramid front-end at the collision zoom costs ~2048*2^sf matmul FLOPs per
sample per SF, so 64 channels x SF7-12 always-on needs ~264 TFLOP/s at
full occupancy.  Real LoRa traffic is sparse
(~1 % duty cycle), so this gateway splits the work in two passes, the same
two-pass detect-then-extract design as dist/triggered.py but with the
Pyramid collision decoder as the extraction stage:

1. **Scan (dense, always-on, cheap)**: per SF, the symbol-strided folded
   up-chirp preamble scan over all channels (dist/triggered.make_preamble
   _scan) at a coarse zoom — ~16*2^sf*ff FLOPs/sample/SF, >1 Gsps for the
   whole SF7-12 bank.
2. **Dispatch (sparse, expensive, exact)**: a window around each detection
   — sized to cover every packet that can COLLIDE with the detected one —
   runs the full two-variant pyramid lattice (models/pyramid), batched
   over events, into a fresh native tracker bank per batch.  A weak packet
   whose preamble is masked by a stronger colliding packet never triggers
   its own event, but it lies inside the stronger packet's window by
   construction, which is exactly the Pyramid use case
   (pyramid_demod_impl.cc peak tracking).

Throughput scales with channel-occupancy, not channel-count: idle air
costs only the scan.  The always-on alternative (every cell, all the
time) is dist/pyramid_gateway.MultiSFPyramidGateway.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PYRAMID_OVERLAP_FACTOR, REQUIRED_PREAMBLE_CHIRPS, LoraConfig
from ..core.header import calc_sym_num
from ..models.modulator import NUM_PREAMBLE_CHIRPS, packet_duration
from ..models.pyramid import PyramidTracker, peak_lattice_fn
from ..ops.cplx import to_ri
from ..pipeline.device_ring import DeviceRing
from .pyramid_gateway import GatewayPacket
from .triggered import make_preamble_scan

#: Scan compile granularity: each SF scans in chunks of about this many
#: SAMPLES (rounded to whole symbol windows, floor below).  Sizing by
#: samples — not a fixed window count — keeps small-SF chunks from
#: degenerating into many tiny dispatches (SF7 at 256 windows would be 64
#: chunks per 1 Msample feed).
_SCAN_CHUNK_SAMPLES = 1 << 20
_SCAN_MIN_WINDOWS = 64

#: The lattice backend (models/pyramid.LATTICE_BACKENDS) the gateway runs
#: unless told otherwise: the faster one on the GPU at the north-star
#: window shapes (``bench.py --mode lattice``; PERF.md).
DEFAULT_BACKEND = "xla"


def _pow2_bucket(x: int, cap: int) -> int:
    """Smallest power of two >= x, clamped to [1, cap]."""
    b = 1
    while b < x:
        b <<= 1
    return min(b, cap)


def _fetch_packets(outs):
    """Fetch a device-tracker output pool in few transfers without
    per-batch recompiles: live-region slices are shaped to power-of-two
    BUCKETS, so only O(log^2) distinct slice programs ever compile (a
    data-dependent [:, :kmax] would be a fresh program per value), while
    the transfer stays ~kmax*lmax, not the whole pool.

    outs = (count, len, pos, syms[..., O, S], *extras) batched on any
    leading axes; returns np arrays (count, len, pos, syms, *extras).
    """
    import jax

    o = outs[3].shape[-2]
    s = outs[3].shape[-1]
    cnt, *extras = (np.asarray(x)
                    for x in jax.device_get((outs[0],) + tuple(outs[4:])))
    kmax = int(cnt.max()) if cnt.size else 0
    if kmax == 0:
        return (cnt, np.zeros(cnt.shape + (0,), np.int32),
                np.zeros(cnt.shape + (0,), np.int32),
                np.zeros(cnt.shape + (0, 0), np.int32), *extras)
    kb = _pow2_bucket(kmax, o)
    o_len, o_pos = (np.asarray(x) for x in jax.device_get(
        (outs[1][..., :kb], outs[2][..., :kb])))
    lb = _pow2_bucket(int(o_len.max()), s)
    o_syms = np.asarray(jax.device_get(outs[3][..., :kb, :lb]))
    return (cnt, o_len, o_pos, o_syms, *extras)


@dataclass
class _SFState:
    cfg: LoraConfig
    scan_cfg: LoraConfig
    win_hops: int                # lattice hops per dispatched window
    lead: int                    # samples before the trigger in the window
    suppress: int                # new events this close after a dispatched
                                 # one are covered by its window already
    scan_windows: int = 256      # symbol windows per scan chunk
    next_scan: int = 0           # abs sample index of next unscanned window
    dispatched: list = field(default_factory=list)   # (ch, abs pos) triggers
    pending: list = field(default_factory=list)      # (ch, abs_pos) events
    recent: dict = field(default_factory=dict)       # decode dedupe


class TriggeredPyramidGateway:
    """Streaming multi-channel multi-SF collision decoder (module doc).

    ``feed(iq)`` consumes ``[channels, T, 2]`` float32 (or complex) in
    arbitrary chunks and returns finished packets; ``flush()`` drains.
    ``max_payload_len`` bounds the packet span a window must cover (a
    production gateway knows its maximum dwell; LoRaWAN caps payloads at
    51 B for SF12).  ``scan_fft_factor`` is the detection zoom — coarser
    than the pyramid's fft_factor because the scan only needs a stable
    argmax, not sub-bin peaks.
    """

    def __init__(self, base: LoraConfig, channels: int,
                 sfs=(7, 8, 9, 10, 11, 12), max_payload_len: int = 32,
                 max_peaks: int = 8, max_events: int = 8,
                 event_batch: int = 8, snr_gate: float = 3.0,
                 scan_fft_factor: int = 2, grace: int = 0,
                 backend: str = DEFAULT_BACKEND,
                 use_native: bool | None = None,
                 decode_payloads: bool = True, bw: float = 125e3,
                 tracker: str = "host", scan_precision: str | None = None,
                 scan_chunk_samples: int = _SCAN_CHUNK_SAMPLES,
                 mesh=None, sic: bool = False, sic_gate: float = 0.02,
                 split_repeats: bool = False):
        #: Opt-in successive interference cancellation (VERDICT r3 task
        #: 5): a dispatched window whose tracker output contains >= 1
        #: tracked packet is re-run through the subtract-and-re-read
        #: loop (models/sic, dechirp-domain fast alignment), so packets
        #: whose preamble was masked by a stronger collider — the
        #: dominant envelope failure — are recovered INSIDE the gateway
        #: path.  Costs one (batched) window fetch per decoded window
        #: (wall['sic']); requires decode_payloads.  Since r5 the
        #: tracker's packets feed sic_demodulate as ``known``, so a
        #: window pays only its cancellations — the dense re-demod runs
        #: ONLY when more than ``sic_gate`` of the window's energy is
        #: left unexplained afterwards (a masked ratio-0.2 collider
        #: holds ~3.8 %, so the 2 % default keeps the 66/66 envelope;
        #: sic_gate=None restores the unconditional full loop).
        self._sic = sic
        self._sic_gate = sic_gate
        self.sic_windows = 0
        #: Opt-in merged-track recovery (adjacent-equal, gapped-run and
        #: adjacent-value symbol merges) in every tracker tier:
        #: models/pyramid.PyramidTracker, the C++ twin
        #: (native/src/pyramid_tracker.cc) and the on-device lax.scan
        #: tracker (models/device_tracker split_extract).
        self._split_repeats = split_repeats
        self.channels = channels
        # -- mesh path (VERDICT r3 task 2): channels are sharded over the
        # mesh's 'ch' axis — the sample ring and the dense scans partition
        # with zero communication (channels are independent); dispatched
        # event-window lattices spread their vmap lanes over 'ch' when the
        # bucket divides, and their (tiny) peak outputs come back
        # replicated so every process takes identical dispatch decisions
        # (SPMD discipline) while emitting only the channels it OWNS (the
        # process hosting the channel's first shard).  Windows are self-
        # contained, so no time sharding is needed inside the gated path
        # (time-block multihost lives in dist/pyramid_gateway).
        self._mesh = mesh
        self._rep = None
        self._ring_sharding = None
        self._lane_sharding = None
        self._own_channels: set | None = None
        if mesh is not None:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P
            nch = mesh.shape.get("ch", 1)
            if channels % nch:
                raise ValueError(f"channels {channels} % ch-shards {nch}")
            self._nch = nch
            self._ring_sharding = NamedSharding(mesh, P("ch", None, None))
            self._lane_sharding = NamedSharding(mesh, P("ch", None, None))
            self._rep = NamedSharding(mesh, P())
            me = jax.process_index()
            ch_axis = mesh.axis_names.index("ch")
            rows = np.moveaxis(np.asarray(mesh.devices), ch_axis, 0)
            rows = rows.reshape(nch, -1)
            cpr = channels // nch
            own = set()
            for i in range(nch):
                if rows[i][0].process_index == me:
                    own.update(range(i * cpr, (i + 1) * cpr))
            self._own_channels = own
        self.max_events = max_events
        self.event_batch = event_batch
        self.snr_gate = snr_gate
        self.grace = grace
        self.backend = backend
        self.max_peaks = max_peaks
        self._decode = decode_payloads
        if tracker not in ("host", "device"):
            raise ValueError(f"tracker must be 'host' or 'device': {tracker}")
        self._device_mode = tracker == "device"
        #: Bounded-pool deviation events from the on-device trackers
        #: (0 = host-exact semantics; see models/device_tracker).
        self.device_deviations = 0
        if use_native is None:
            from .. import native as _native
            use_native = _native.available()
        self._native = use_native

        # The scan only needs a stable argmax + a 3x-mean dominance gate,
        # not sub-bin peak accuracy, so it can run a cheaper matmul
        # precision than the extraction lattice (bf16);
        # None inherits the base config's tier.
        scan_precision = scan_precision or base.precision

        self.sf_states: dict[int, _SFState] = {}
        for sf in sfs:
            ldr = (1 << sf) / bw > 16e-3   # SX127x LDR rule (rx_file.grc)
            cfg = base.replace(sf=sf, ldr=ldr)
            n = cfg.num_samples
            hop = n // PYRAMID_OVERLAP_FACTOR
            nsyms = calc_sym_num(max_payload_len, sf=cfg.sf, cr=cfg.cr,
                                 crc=cfg.crc, ldr=cfg.ldr,
                                 explicit_header=cfg.explicit_header)
            span = packet_duration(nsyms, cfg)     # preamble + payload
            # Flush margin: hops to retire every live track and TTL
            # (PyramidTracker.flush_hops) plus the grace extension.
            flush = (PyramidTracker(cfg, grace=grace).flush_hops()
                     + grace) * hop
            lead = 4 * n
            # Window covers: lead + the triggering packet + any packet
            # still colliding with it (starting up to one span later) +
            # the tracker flush.  Events within `suppress` of a dispatched
            # trigger are inside its window with >= span+flush remaining.
            want = lead + 2 * span + flush
            win_hops = -(-(want - (n - hop)) // hop)    # ceil to hop grid
            self.sf_states[sf] = _SFState(
                cfg=cfg,
                scan_cfg=cfg.replace(fft_factor=scan_fft_factor,
                                     precision=scan_precision),
                win_hops=win_hops, lead=lead, suppress=span,
                scan_windows=max(_SCAN_MIN_WINDOWS,
                                 scan_chunk_samples // n))

        # Samples live in HBM (pipeline/device_ring): the window lead is
        # pre-filled zero history so every dispatched window offset is
        # in-span, and _base starts at -history to keep absolute positions
        # identical to the host-buffer formulation.
        history = max(st.lead for st in self.sf_states.values())
        hint = max(
            (st.scan_windows + REQUIRED_PREAMBLE_CHIRPS + 2)
            * st.cfg.num_samples + self._win_samples(st) + st.lead
            for st in self.sf_states.values())
        self._ring = DeviceRing(channels, hint + history, history=history,
                                sharding=self._ring_sharding)
        self._base = -history                # abs index of span offset 0
        self._scan_fns: dict = {}
        self._lattice_fns: dict = {}
        self.out_pending: list[GatewayPacket] = []
        #: Wall split: ingest = host->device upload sync (zero when fed
        #: device-resident arrays); scan = dense detection (device);
        #: lattice = window dispatch+fetch; tracker / decode = host.
        self.wall = {"ingest": 0.0, "scan": 0.0, "lattice": 0.0,
                     "tracker": 0.0, "decode": 0.0, "sic": 0.0}
        #: Finer attribution of wall['lattice'] (r5 observability):
        #: 'gather' = on-device window gather dispatch, 'dispatch' =
        #: lattice program launch (async send), 'fetch' = grouped
        #: packed-peak device_get syncs.
        self.lattice_split = {"gather": 0.0, "dispatch": 0.0, "fetch": 0.0}
        #: Samples dispatched to the pyramid lattice (occupancy metric;
        #: includes window overlap) vs samples scanned.
        self.dispatched_samples = 0
        self.scanned_samples = 0
        #: Events dropped because the per-scan top-k slots overflowed.
        self.dropped_events = 0

    def wall_reset(self) -> dict:
        prev = dict(self.wall)
        for k in self.wall:
            self.wall[k] = 0.0
        for k in self.lattice_split:
            self.lattice_split[k] = 0.0
        return prev

    # -- plumbing ---------------------------------------------------------
    def _bucket(self, events: list) -> list:
        """Split events into batches: full event_batch chunks, then ONE
        power-of-two bucket for the remainder — unused vmap lanes re-run
        the whole lattice window, so padding 3 events to 8 lanes is 62 %
        wasted matmul time (the r3 north-star bench padded ~45 % of its
        SF9-12 lane-samples).  Power-of-two buckets keep the compiled-
        shape set O(log eb); ``warmup()`` pre-compiles all of them."""
        out = []
        i = 0
        while len(events) - i >= self.event_batch:
            out.append(events[i:i + self.event_batch])
            i += self.event_batch
        rest = events[i:]
        if rest:
            out.append(rest)
        return out

    def warmup(self) -> None:
        """Compile every (SF, batch-bucket) lattice/tracker program and
        every scan on zero input, so first real traffic (or a bench's
        timed region) never hits the compiler — production gateways pay
        this at boot, not on the first packet (the persistent compile
        cache, gr_lora_tpu.runtime, carries it across processes)."""
        for st in self.sf_states.values():
            self._scan(st)(self._zeros(
                (self.channels, st.scan_windows * st.cfg.num_samples, 2),
                self._ring_sharding))
            win = self._win_samples(st)
            fn = (self._device_window_fn(st) if self._device_mode
                  else self._lattice(st))
            eb = 1
            outs = []
            while eb <= self.event_batch:
                outs.append(fn(self._zeros((eb, win, 2))))
                eb <<= 1
            jax.device_get(jax.tree.map(lambda x: x[0], outs))
            if self._sic:
                # The SIC fast path probes tone peaks via jitted up/down
                # programs (models/sic._peak_fns); compile them now too.
                from ..models.sic import _peak_fns
                up, down = _peak_fns(st.cfg)
                w = jnp.zeros((st.cfg.num_samples, 2), jnp.float32)
                # Also the first _reextract batch bucket (refine path):
                # its (16, n, 2) shape is a separate compile.
                wb = jnp.zeros((16, st.cfg.num_samples, 2), jnp.float32)
                jax.device_get((up(w), down(w), up(wb)))

    def _win_samples(self, st: _SFState) -> int:
        n = st.cfg.num_samples
        hop = n // PYRAMID_OVERLAP_FACTOR
        return st.win_hops * hop + (n - hop)

    def _scan(self, st: _SFState):
        key = st.cfg.sf
        if key not in self._scan_fns:
            fn = make_preamble_scan(
                st.scan_cfg, st.scan_windows, self.max_events,
                self.snr_gate)
            if self._mesh is not None:
                # Replicated detections: every process fetches the same
                # (tiny) result and takes identical dispatch decisions.
                fn = jax.jit(fn, out_shardings=self._rep)
            self._scan_fns[key] = fn
        return self._scan_fns[key]

    #: HBM budget for one dispatched lattice batch.  The dense per-hop
    #: spectra dominate peak memory at roughly _LATTICE_TEMPS live
    #: f32[block, bins] temporaries per vmap lane (measured from XLA
    #: allocation dumps at SF12 x ff=8: ~20 fusion temps + remat copies),
    #: so the hop-block size is solved from this budget, leaving the
    #: device's memory to the sample ring and the scans.
    _LATTICE_BUDGET_BYTES = 4 << 30
    _LATTICE_TEMPS = 32

    def _lattice_block_hops(self, st: _SFState) -> int | None:
        per_hop = (self.event_batch * st.cfg.bin_size * 4
                   * self._LATTICE_TEMPS)
        blk = max(int(self._LATTICE_BUDGET_BYTES // per_hop), 32)
        return blk if blk < st.win_hops else None

    def _lattice(self, st: _SFState):
        key = st.cfg.sf
        if key not in self._lattice_fns:
            from .pyramid_gateway import _pack_peaks
            run = peak_lattice_fn(st.cfg, st.win_hops, self.max_peaks,
                                  self.backend,
                                  block_hops=self._lattice_block_hops(st))

            def packed(xs):
                # 8 B/peak instead of 13 for the device->host fetch
                # (~810 KB/batch raw at eb=8, M=8).
                xs = self._constrain_lanes(xs)
                return _pack_peaks(jax.vmap(run)(xs))

            self._lattice_fns[key] = jax.jit(
                packed, out_shardings=self._rep) \
                if self._mesh is not None else jax.jit(packed)
        return self._lattice_fns[key]

    def _constrain_lanes(self, xs):
        """Mesh: spread event-window vmap lanes over the 'ch' devices when
        the bucket divides; small buckets replicate (idle shards cost
        nothing extra — they would otherwise idle anyway)."""
        if self._mesh is None:
            return xs
        s = self._lane_sharding if xs.shape[0] % self._nch == 0 \
            else self._rep
        return jax.lax.with_sharding_constraint(xs, s)

    def _device_window_fn(self, st: _SFState):
        """Fused window decoder for tracker='device': lattice + on-device
        tracker + flush, one pure jit — windows are self-contained, so the
        state is born and dies inside the call and only finished packets
        (plus the deviation total) are fetched."""
        key = st.cfg.sf
        if key not in self._lattice_fns:
            import jax.numpy as jnp

            from ..models.device_tracker import (_DEVIATION_COUNTERS,
                                                 flush_hops,
                                                 make_device_tracker)
            init1, proc = make_device_tracker(
                st.cfg, self.max_peaks, self.grace,
                split_repeats=self._split_repeats)
            run = peak_lattice_fn(st.cfg, st.win_hops, self.max_peaks,
                                  self.backend,
                                  block_hops=self._lattice_block_hops(st))
            fh = flush_hops(self.grace) + self.grace

            def one(x):
                state = proc(init1(), *run(x))
                z = jnp.zeros((fh, self.max_peaks), jnp.float32)
                state = proc(state, z.astype(jnp.int32), z, z,
                             z.astype(bool))
                dev = sum(state[k] for k in _DEVIATION_COUNTERS)
                return (state["o_count"], state["o_len"], state["o_pos"],
                        state["o_syms"], dev)

            def batch(xs):
                return jax.vmap(one)(self._constrain_lanes(xs))

            self._lattice_fns[key] = jax.jit(
                batch, out_shardings=self._rep) \
                if self._mesh is not None else jax.jit(batch)
        return self._lattice_fns[key]

    # -- streaming --------------------------------------------------------
    def feed(self, iq) -> list[GatewayPacket]:
        """``iq``: [channels, T, 2] float32 (or [channels, T] complex) —
        a host ndarray (uploaded once; the host->device copy shows in
        wall['ingest']) or an already-on-device jax array (no link
        traffic — the production pinned-buffer path)."""
        host = isinstance(iq, np.ndarray) or np.iscomplexobj(iq)
        if np.iscomplexobj(iq):
            iq = to_ri(np.asarray(iq))
        if isinstance(iq, np.ndarray):
            iq = np.asarray(iq, np.float32)
        if iq.ndim == 2:
            iq = iq[None]
        assert iq.shape[0] == self.channels, (iq.shape, self.channels)
        t0 = time.perf_counter()
        self._ring.append(iq)
        if host:
            self._ring.sync()
            self.wall["ingest"] += time.perf_counter() - t0
        out = self._process(final=False)
        self._trim()
        return out

    def _zeros(self, shape, sharding=None):
        if self._mesh is None:
            return jnp.zeros(shape, jnp.float32)
        from functools import partial as _p
        return jax.jit(_p(jnp.zeros, shape, jnp.float32),
                       out_shardings=sharding or self._rep)()

    def flush(self) -> list[GatewayPacket]:
        """Zero-pad so every pending window and scan chunk completes."""
        pad = max((self._win_samples(st) + st.lead
                   + (st.scan_windows + 1) * st.cfg.num_samples
                   for st in self.sf_states.values()), default=0)
        self._ring.append(self._zeros((self.channels, pad, 2),
                                      self._ring_sharding))
        out = self._process(final=True)
        self._trim()
        return out

    #: In-flight lattice batches before a grouped drain of half the queue
    #: in one device_get.  Each parked batch holds only its ~0.25 MB
    #: packed-peak output on the device (plus its window slices when
    #: sic=True).  Not yet tuned on the GPU.
    _MAX_INFLIGHT = 16

    def _process(self, final: bool) -> list[GatewayPacket]:
        end = self._base + self._ring.length
        out: list[GatewayPacket] = list(self.out_pending)
        self.out_pending = []
        # Three-phase: (a) launch EVERY SF's scan chunks async and fetch
        # the (tiny) detection results in ONE device_get rather than one
        # synchronous fetch per chunk per SF; (b) launch every ready
        # lattice batch async; (c) drain — the first drain's sync
        # overlaps the remaining batches' compute with host
        # tracking/decode of earlier ones.
        t0 = time.perf_counter()
        launched = []                        # (st, chunk_start, outs)
        for st in self.sf_states.values():
            launched += self._scan_launch(st, end)
        if launched:
            fetched = jax.device_get([o for _, _, o in launched])
            self.wall["scan"] += time.perf_counter() - t0
            for (st, start, _), res in zip(launched, fetched):
                self._scan_collect(st, start, res)
        inflight: list = []
        for sf, st in self.sf_states.items():
            win = self._win_samples(st)
            ready = [(ch, pos) for ch, pos in st.pending
                     if pos - st.lead + win <= end]
            if not ready:
                continue
            st.pending = [e for e in st.pending if e not in ready]
            for batch in self._bucket(ready):
                inflight.append(self._launch_batch(st, batch, win))
                if len(inflight) > self._MAX_INFLIGHT:
                    # Drain HALF the queue in one grouped fetch; the
                    # other half keeps computing while the host tracks
                    # these.
                    take = inflight[:self._MAX_INFLIGHT // 2]
                    del inflight[:self._MAX_INFLIGHT // 2]
                    out += self._drain_group(take)
        # Host-tracker drains fetch ALL queued batches in one device_get;
        # device-tracker drains stay per-batch — their fetch is two tiny
        # data-dependent bucket slices each (_fetch_packets).
        out += self._drain_group(inflight)
        out.sort(key=lambda p: (p.channel, p.position))
        return out

    def _drain_group(self, items: list) -> list[GatewayPacket]:
        """Drain a list of in-flight lattice batches.  Host mode fetches
        every batch's packed peaks in ONE device_get (one transfer for the
        group); device mode stays per-batch — its fetch is two tiny
        data-dependent bucket slices each (_fetch_packets)."""
        out: list[GatewayPacket] = []
        if not items:
            return out
        if self._device_mode:
            for item in items:
                out += self._drain_batch(*item)
            return out
        t0 = time.perf_counter()
        fetched = jax.device_get([o for _, _, o, _ in items])
        dt = time.perf_counter() - t0
        self.wall["lattice"] += dt
        self.lattice_split["fetch"] += dt
        for (st, events, _, sl), res in zip(items, fetched):
            out += self._track_fetched(st, events, res, sl)
        return out

    def _scan_launch(self, st: _SFState, end: int) -> list:
        """Queue the preamble scan over every complete chunk of new windows
        (async — results fetched by the caller in one batched device_get);
        chunks overlap by the preamble run length so a preamble straddling
        a chunk boundary is still detected (events dedupe by position)."""
        n = st.cfg.num_samples
        chunk = st.scan_windows * n
        overlap_w = REQUIRED_PREAMBLE_CHIRPS + 2
        launched = []
        while st.next_scan + chunk <= end:
            lo = st.next_scan - self._base
            seg = self._ring.slice(lo, chunk)
            launched.append((st, st.next_scan, self._scan(st)(seg)))
            self.scanned_samples += self.channels * chunk
            st.next_scan += chunk - overlap_w * n
        return launched

    def _scan_collect(self, st: _SFState, chunk_start: int, res):
        """Turn one fetched scan-chunk result into pending events."""
        n = st.cfg.num_samples
        starts, valid, nhits = (np.asarray(x) for x in res)
        self.dropped_events += int(
            np.sum(np.maximum(nhits - self.max_events, 0)))
        for ch in map(int, np.nonzero(valid.any(axis=1))[0]):
            for e in np.sort(starts[ch][valid[ch]]):
                pos = chunk_start + int(e) * n
                # Covered by an already-dispatched window on THIS
                # channel, or a repeat detection from the chunk overlap?
                if any(dc == ch and d - 2 * n <= pos < d + st.suppress
                       for dc, d in st.dispatched) or \
                   any(c == ch and p == pos for c, p in st.pending):
                    continue
                st.pending.append((ch, pos))
        # Drop dispatch history that can no longer suppress anything.
        chunk = st.scan_windows * n
        st.dispatched = [(dc, d) for dc, d in st.dispatched
                         if d + st.suppress > st.next_scan - chunk]

    def _launch_batch(self, st: _SFState, events, win):
        """Gather the event windows on-device and queue the lattice (and,
        in device mode, the fused tracker) — async, no sync here.  The
        vmap lane count is the power-of-two bucket of len(events), not a
        fixed event_batch (see _bucket)."""
        eb = _pow2_bucket(len(events), self.event_batch)
        # Window gather stays on-device: [eb, win, 2] HBM->HBM.  Unused
        # batch lanes re-read window 0 of channel 0 — _emit drops results
        # with i >= len(events), so their decodes are never surfaced.
        chs = np.zeros(eb, np.int32)
        los = np.zeros(eb, np.int64)
        for i, (ch, pos) in enumerate(events):
            chs[i] = ch
            los[i] = pos - st.lead - self._base
            st.dispatched.append((ch, pos))
        t0 = time.perf_counter()
        slices = self._ring.gather(chs, los, win)
        self.dispatched_samples += len(events) * win
        t1 = time.perf_counter()
        fn = self._device_window_fn(st) if self._device_mode \
            else self._lattice(st)
        outs = fn(slices)
        t2 = time.perf_counter()
        self.wall["lattice"] += t2 - t0
        self.lattice_split["gather"] += t1 - t0
        self.lattice_split["dispatch"] += t2 - t1
        # SIC needs the window samples again after decode; keep the device
        # slices alive with the batch (freed when the batch drains).
        return st, events, outs, (slices if self._sic else None)

    def _drain_batch(self, st: _SFState, events, outs,
                     slices=None) -> list[GatewayPacket]:
        t0 = time.perf_counter()
        if self._device_mode:
            cnt, o_len, o_pos, o_syms, dev = _fetch_packets(outs)
            self.device_deviations += int(np.sum(dev))
            self.wall["lattice"] += time.perf_counter() - t0
            results = [(i, int(o_pos[i, j]),
                        o_syms[i, j, :o_len[i, j]].astype(np.uint16))
                       for i in range(cnt.shape[0])
                       for j in range(int(cnt[i]))]
            results = self._maybe_sic(st, events, results, slices)
            t2 = time.perf_counter()
            return self._emit(st, events, results, t2)

        res = jax.device_get(outs)
        self.wall["lattice"] += time.perf_counter() - t0
        return self._track_fetched(st, events, res, slices)

    def _maybe_sic(self, st: _SFState, events, results, slices):
        """Re-run decoded windows through subtract-and-re-read (module
        ``sic`` flag).  A lane with >= 1 cleanly-decoded packet has its
        window fetched once and its results REPLACED by the SIC output
        (pass 0 reproduces the tracker's packets; later passes add the
        masked ones) — see models/sic.sic_demodulate."""
        if not self._sic or slices is None or not self._decode:
            return results
        from ..models.sic import sic_demodulate
        t0 = time.perf_counter()
        by_lane: dict[int, list] = {}
        for i, ts, syms in results:
            by_lane.setdefault(i, []).append((ts, syms))
        # Any tracked packet qualifies the window: a clean one may be
        # masking a preamble-less collider (the 66/66 envelope case), an
        # unclean one is exactly what subtract-and-re-read repairs
        # (_refine re-reads it with the others cancelled).  Empty lanes —
        # the common noise-triggered window — stay free.  All qualifying
        # windows fetch in ONE device_get rather than one per lane.
        lanes = [i for i in range(len(events)) if by_lane.get(i)]
        fetched_wins = {}
        if lanes:
            got = jax.device_get([slices[i] for i in lanes])
            fetched_wins = dict(zip(lanes, got))
        new = []
        for i in range(len(events)):
            lane = by_lane.get(i, [])
            if not lane:
                continue
            win_ri = np.asarray(fetched_wins[i])
            wiq = (win_ri[..., 0] + 1j * win_ri[..., 1]
                   ).astype(np.complex64)
            pkts = sic_demodulate(
                wiq, st.cfg, max_peaks=self.max_peaks,
                backend=self.backend, grace=self.grace, fast_align=True,
                lattice_block_hops=self._lattice_block_hops(st),
                split_repeats=self._split_repeats,
                known=lane, residual_gate=self._sic_gate)
            self.sic_windows += 1
            new += [(i, int(q.position),
                     np.asarray(q.symbols, np.uint16)) for q in pkts]
        self.wall["sic"] += time.perf_counter() - t0
        return new

    def _track_fetched(self, st: _SFState, events, res,
                       slices=None) -> list[GatewayPacket]:
        """Host-track one already-fetched (packed) lattice batch result."""
        from .pyramid_gateway import _unpack_peaks
        t1 = time.perf_counter()
        bins, h, hs, valid = _unpack_peaks(np.asarray(res))
        eb = bins.shape[0]

        # Fresh tracker bank per batch (windows are self-contained); the
        # flush is host-only empty hops — no device work.
        flush_hops = (PyramidTracker(st.cfg, grace=self.grace).flush_hops()
                      + self.grace)
        if self._native:
            from .. import native as _native
            bank = _native.MultiPyramidTracker(
                st.cfg, eb, grace=self.grace,
                split_repeats=self._split_repeats)
            bank.feed(bins, h, hs, valid)
            z = np.zeros((eb, flush_hops, self.max_peaks), np.float32)
            bank.feed(z.astype(np.int32), z, z, z.astype(bool))
            results = bank.drain()
        else:
            results = []
            for i in range(eb):
                tr = PyramidTracker(st.cfg, grace=self.grace,
                                    split_repeats=self._split_repeats)
                for t in range(st.win_hops):
                    v = valid[i, t]
                    if v.any():
                        order = np.argsort(bins[i, t][v], kind="stable")
                        tr.step(bins[i, t][v][order], h[i, t][v][order],
                                hs[i, t][v][order])
                    else:
                        tr.step()
                for _ in range(flush_hops):
                    tr.step()
                results += [(i, p, s) for p, s in
                            zip(tr.positions_out, tr.symbols_out)]
        t2 = time.perf_counter()
        self.wall["tracker"] += t2 - t1
        results = self._maybe_sic(st, events, results, slices)
        return self._emit(st, events, results, time.perf_counter())

    def _emit(self, st: _SFState, events, results,
              t2: float) -> list[GatewayPacket]:
        n = st.cfg.num_samples
        out: list[GatewayPacket] = []
        for i, ts, syms in results:
            if i >= len(events):
                continue
            ch, pos = events[i]
            # Mesh/multihost: every process tracks the replicated batch;
            # only the channel's owner emits (and dedupes) its packets.
            if self._own_channels is not None and \
                    ch not in self._own_channels:
                continue
            abs_pos = pos - st.lead + int(ts)
            # Cross-window dedupe: the same packet decodes in every window
            # that covers it; positions agree to within a couple symbols.
            key = (ch, syms.tobytes())
            last = st.recent.get(key)
            if last is not None and abs(abs_pos - last) < 4 * n:
                continue
            st.recent[key] = abs_pos
            res = None
            if self._decode:
                from ..core.codec import decode
                res = decode(syms, st.cfg)
            out.append(GatewayPacket(ch, syms, res, abs_pos, st.cfg.sf))
        self.wall["decode"] += time.perf_counter() - t2
        if len(st.recent) > 4096:      # bound the dedupe memory
            cutoff = self._base
            st.recent = {k: v for k, v in st.recent.items() if v >= cutoff}
        return out

    def _trim(self):
        """Discard buffer samples nothing can reference any more."""
        keep_from = self._base + self._ring.length
        for st in self.sf_states.values():
            # Dispatched windows read back to pos - lead; scans back to
            # next_scan.  Keep the largest lead of history before either so
            # a future event's window never reaches past the span start.
            lo_scan = st.next_scan - st.lead
            lo_pend = min((pos - st.lead for _, pos in st.pending),
                          default=keep_from)
            keep_from = min(keep_from, lo_scan, lo_pend)
        cut = keep_from - self._base
        if cut > 0:
            self._ring.trim(cut)
            self._base += cut

    def stats(self) -> dict:
        return {
            "ingest_bytes": self._ring.ingest_bytes,
            "dispatched_samples": self.dispatched_samples,
            "scanned_samples": self.scanned_samples,
            "duty_cycle": (self.dispatched_samples
                           / max(self.scanned_samples // len(self.sf_states),
                                 1)),
            "dropped_events": self.dropped_events,
            "pending_events": sum(len(st.pending)
                                  for st in self.sf_states.values()),
            "device_deviations": self.device_deviations,
            "sic_windows": self.sic_windows,
        }
