"""Detection-gated demodulation: dense preamble scan + targeted FSM demod.

The FSM demodulator walks every symbol period of every channel x SF stream
even when the air is idle.  Real gateway traffic is sparse (sub-1% duty
cycle), so this receiver splits the work in two passes (the two-pass
detect-then-extract design from SURVEY.md §7.4):

1. **Scan (dense, batched)**: per SF, one symbol-strided folded up-chirp
   spectrum lattice over all channels — a single packed matmul at
   ~100+ Msps/chip.  A preamble shows as a run of >= 4 consecutive windows
   whose argmax stays put (within the LDR drift tolerance) and whose peak
   dominates the spectrum (peak > snr_gate * spectrum mean), exactly the
   FSM's detection predicate evaluated everywhere at once.
2. **Demod (sparse, targeted)**: a fixed-size packet window is sliced
   around each detection and only those windows run the full FSM
   (vmapped over detections).

Throughput scales with occupancy, not stream length: the idle fraction
costs one matmul pass instead of per-symbol FSM steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..config import REQUIRED_PREAMBLE_CHIRPS, LoraConfig
from ..core.codec import DecodeResult, decode
from ..models.demodulator import demod_fn, max_packet_symbols
from ..models.modulator import NUM_PREAMBLE_CHIRPS, packet_duration
from ..ops.cplx import cmag
from ..ops.dechirp import up_bands


def scan_window(cfg: LoraConfig) -> int:
    """Samples sliced around each detection: preamble lead-in + the longest
    packet + sync margin."""
    n = cfg.num_samples
    return (NUM_PREAMBLE_CHIRPS + 4) * n \
        + packet_duration(max_packet_symbols(cfg), cfg) + 4 * n


@lru_cache(maxsize=None)
def make_preamble_scan(cfg: LoraConfig, num_windows: int, max_events: int = 8,
                       snr_gate: float = 3.0):
    """Jitted: iq [C, T, 2] -> (starts int32[C, E], valid bool[C, E],
    nhits int32[C]) — the window indices where a fresh preamble run begins,
    plus the total hit count (so hits beyond max_events are observable)."""
    n = cfg.num_samples
    drift = cfg.preamble_drift_max
    k = cfg.bin_size
    need = REQUIRED_PREAMBLE_CHIRPS

    def run(iq):
        c, t, _ = iq.shape
        frames = iq[:, : num_windows * n, :].reshape(c, num_windows, n, 2)
        lo, hi = up_bands(frames, cfg)
        folded = cmag(lo) + cmag(hi)                     # [C, W, K]
        idx = jnp.argmax(folded, axis=-1)
        val = jnp.take_along_axis(folded, idx[..., None], -1)[..., 0]
        mean = jnp.mean(folded, axis=-1)
        strong = val > snr_gate * mean

        # Consecutive windows agreeing within the drift tolerance.  A window
        # 'agrees' with its predecessor if the cyclic argmax distance is
        # small (demod_impl.cc:418-427).
        dis = jnp.mod(idx[:, 1:] - idx[:, :-1] + k, k)
        agree = (dis <= drift) | (dis >= k - drift)
        agree = jnp.concatenate(
            [jnp.zeros((c, 1), bool), agree], axis=1) & strong

        # Run length ending at each window (0 where not agreeing).
        def scan_run(carry, a):
            r = jnp.where(a, carry + 1, 0)
            return r, r

        _, runs = jax.lax.scan(scan_run, jnp.zeros(c, jnp.int32),
                               jnp.swapaxes(agree, 0, 1))
        runs = jnp.swapaxes(runs, 0, 1)                  # [C, W]
        # Detection: the FIRST window where the run reaches need-1 agreements
        # (i.e. `need` matching windows); later windows of the same preamble
        # have longer runs and are suppressed.
        hit = runs == (need - 1)
        score = jnp.where(hit, 1.0, 0.0) \
            * (1.0 + jnp.arange(num_windows, 0, -1)[None, :])
        # A chunk shorter than max_events windows (high SF on a small
        # scan block, e.g. SF12 at bench --mode scan --quick) can only
        # carry num_windows detections; top_k rejects k > axis size.
        vals, starts = jax.lax.top_k(score, min(max_events, num_windows))
        valid = vals > 0.0
        # Back up to the start of the run.
        starts = jnp.maximum(starts - (need - 1), 0)
        nhits = jnp.sum(hit, axis=1, dtype=jnp.int32)
        return starts.astype(jnp.int32), valid, nhits

    return jax.jit(run)


@dataclass
class TriggeredPacket:
    channel: int
    sf: int
    position: int            # sample index of the detection window start
    symbols: np.ndarray
    result: DecodeResult
    #: Peak/mean detection ratio (models.demodulator.snr_db_estimate).
    snr_ratio: float = 0.0


class TriggeredReceiver:
    """Scan everywhere, demodulate only where preambles exist."""

    def __init__(self, base: LoraConfig, sfs=(7, 8, 9, 10, 11, 12),
                 max_events: int = 8, snr_gate: float = 3.0,
                 bw: float = 125e3):
        self.cfgs = {sf: base.replace(sf=sf, ldr=(1 << sf) / bw > 16e-3)
                     for sf in sfs}
        self.max_events = max_events
        self.snr_gate = snr_gate
        self._demods: dict = {}
        #: Detections beyond the max_events slots (raise it if nonzero).
        self.dropped_events = 0
        #: Demod-FSM packet-slot overflow across all triggered windows.
        self.dropped_packets = 0

    def _demod(self, cfg: LoraConfig, win: int):
        key = (cfg.sf, win)
        if key not in self._demods:
            self._demods[key] = jax.jit(jax.vmap(demod_fn(cfg, win, 2)))
        return self._demods[key]

    def __call__(self, iq) -> list[TriggeredPacket]:
        if np.iscomplexobj(iq):
            iq = np.stack([np.asarray(iq).real, np.asarray(iq).imag], -1)
        iq = np.asarray(iq, np.float32)
        if iq.ndim == 2:
            iq = iq[None]
        c, t, _ = iq.shape
        diq = jnp.asarray(iq)        # cross the host->device link ONCE;
        out: list[TriggeredPacket] = []   # every SF scans the same copy
        for sf, cfg in self.cfgs.items():
            n = cfg.num_samples
            nw = t // n
            if nw < REQUIRED_PREAMBLE_CHIRPS + 1:
                continue
            scan = make_preamble_scan(cfg, nw, self.max_events, self.snr_gate)
            starts, valid, nhits = (np.asarray(x) for x in
                                    jax.device_get(scan(diq)))
            self.dropped_events += int(
                np.sum(np.maximum(nhits - self.max_events, 0)))
            win = min(scan_window(cfg), t)
            # Re-trigger suppression: one event per PREAMBLE, not per max
            # packet window — dense back-to-back traffic has many packets
            # inside one window (they all demodulate from the same slice;
            # the output dedupe below collapses cross-window repeats).
            suppress = (NUM_PREAMBLE_CHIRPS + 4) * n
            events = []       # (channel, sample_start)
            for ch in range(c):
                seen: list[int] = []
                for e in sorted(range(self.max_events),
                                key=lambda e: int(starts[ch, e])):
                    if not valid[ch, e]:
                        continue
                    pos = int(starts[ch, e]) * n
                    if any(abs(pos - s) < suppress for s in seen):
                        continue
                    seen.append(pos)
                    # Anchor the slice at ITS trigger (zero-pad past the
                    # capture end) so the triggered packet is always the
                    # first the FSM meets — clamping right would make
                    # dense-traffic events share one window and exhaust
                    # the packet slots on earlier packets.
                    events.append((ch, max(pos - 2 * n, 0)))
            if not events:
                continue
            slices = np.zeros((len(events), win, 2), np.float32)
            for i, (ch, s) in enumerate(events):
                seg = iq[ch, s:min(s + win, t)]
                slices[i, :seg.shape[0]] = seg
            syms, lens, pos, cnt, dropped, snr = (
                np.asarray(x) for x in
                jax.device_get(self._demod(cfg, win)(jnp.asarray(slices))))
            self.dropped_packets += int(np.sum(dropped))
            for i, (ch, s) in enumerate(events):
                for r in range(int(cnt[i])):
                    symbols = syms[i, r, :lens[i, r]].copy()
                    res = decode(symbols, cfg)
                    if res.ok:
                        out.append(TriggeredPacket(
                            ch, sf, s + int(pos[i, r]), symbols, res,
                            float(snr[i, r])))
        # Overlapping event windows demodulate shared packets more than
        # once (a packet is first in its own window and later in earlier
        # windows); detection positions agree only to within a symbol or
        # two of window phase, so merge same-(channel, sf, bytes) packets
        # closer than 4 symbols.
        out.sort(key=lambda p: (p.channel, p.sf, p.position))
        deduped: list[TriggeredPacket] = []
        for p in out:
            n = self.cfgs[p.sf].num_samples
            if deduped:
                q = deduped[-1]
                if (q.channel == p.channel and q.sf == p.sf
                        and abs(p.position - q.position) < 4 * n
                        and bytes(q.result.payload) == bytes(p.result.payload)):
                    continue
            deduped.append(p)
        deduped.sort(key=lambda p: (p.channel, p.position))
        return deduped
