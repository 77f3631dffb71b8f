"""Soak driver: sustained-air streaming-state hygiene for the gateway.

VERDICT r3 task 8 / SURVEY §5 long-context row.  One shared generator +
checker used by BOTH tests/test_soak.py (CPU mesh, minutes of simulated
air) and ``bench.py --mode soak`` (GPU, >= 30 simulated minutes per
channel), so the hygiene assertions are identical in both places:

- every injected single packet decodes byte-exact exactly once (DeviceRing
  compaction/growth across many wraps never feeds a window stale samples),
- ``st.recent`` dedupe, pending-event and dispatch-history state stays
  bounded, no dropped events, zero device-tracker deviations,
- the ring capacity settles after warm-up (``_trim`` reclaims the stream).

The reference holds an unbounded GR stream open indefinitely
(lib/demod_impl.cc:130); this is the bounded-memory equivalent.
"""

from __future__ import annotations

import numpy as np

from ..core.codec import encode
from ..models.modulator import modulate
from ..ops.cplx import to_ri

__all__ = ["run_gateway_soak", "check_soak"]


def _pkt(cfg, payload, amp):
    return amp * modulate(encode(payload, cfg), cfg,
                          pad_front=0, pad_back=0)


def _pyramid_safe_payload(cfg, inj, ch, sf):
    """A unique 8-byte payload whose symbol encoding has no two adjacent
    equal symbols.  Adjacent repeats are a Pyramid-ALGORITHM landmine
    (reference parity): the repeated symbol's peaks merge into one
    over-long track, which the classifier rejects as data
    (pyramid_demod_impl.cc:319-391, data tracks <= 2*overlaps), and the
    assembly walk then stops at the resulting empty window
    (pyramid_demod_impl.cc:680-767) — truncating the packet in the
    reference and here alike (tests/test_soak.py::
    test_repeated_symbol_is_a_pyramid_landmine).  The reference-parity
    soak variant (``split_repeats=False`` gateways) streams payloads the
    reference Pyramid engine decodes by construction — as its demos do;
    the product config soaks UNCURATED traffic (_uncurated_payload)."""
    for salt in range(256):
        pay = bytes([inj & 0xFF, 0xA0 | ch, sf, salt, 2, 3, 4, 5])
        tx = np.asarray(encode(pay, cfg))
        if not np.any(tx[1:] == tx[:-1]):
            return pay
    raise AssertionError("no repeat-free payload found")


#: Fixed payloads whose encodings carry a >= 3-symbol equal RUN at the
#: given SF (found by search; pinned because random payloads carry a
#: 3-run with probability ~25/2^sf — too rare to sample on demand).
_KNOWN_RUN_PAYLOADS = {
    7: bytes([1, 2, 3, 4, 5, 6]),               # 1,1,1 (golden payload)
    8: bytes([12, 144, 170, 153, 199, 38]),
    9: bytes([183, 74, 76, 136, 42, 115]),
    10: bytes([1, 2, 3, 4, 5, 6]),
    11: bytes([136, 88, 19, 83, 7, 2]),
    12: bytes([254, 221, 147, 24, 78, 203]),
}


def _uncurated_payload(cfg, inj, ch, sf, rng):
    """Uncurated product-config traffic (VERDICT r4 weak #1): random
    payloads, with every landmine class ``split_repeats=True`` exists to
    decode deliberately seeded on a fixed cadence — adjacent EQUAL
    symbols (merged track), adjacent-VALUE symbols (leakage-bridged
    merge), and >= 3-symbol runs.  The (inj, ch, sf) tag keeps accounting
    keys distinct across channels/SFs; repeats of a payload are counted,
    not deduped (check_soak compares multisets)."""
    want = (None, "repeat", "adjacent", "run")[inj % 4]
    if want == "run":
        base = _KNOWN_RUN_PAYLOADS.get(sf)
        if base is not None:
            return base
        want = "repeat"     # no pinned run fixture at this SF
    if want == "adjacent" and cfg.ldr:
        # LDR symbols sit on the (g*4+1) lattice (encode_impl.cc:133):
        # adjacent-VALUE encoded symbols cannot occur, and the 4-unit
        # minimum spacing exceeds the track bin tolerance anyway.
        want = "repeat"
    for _ in range(512):
        pay = bytes([inj & 0xFF, 0xA0 | ch, sf]) \
            + bytes(int(b) for b in rng.integers(0, 256, 5))
        if want is None:
            return pay
        tx = np.asarray(encode(pay, cfg)).astype(np.int64)
        d = np.abs(tx[1:] - tx[:-1])
        if (want == "repeat" and np.any(d == 0)) or \
                (want == "adjacent" and np.any(d == 1)):
            return pay
    return pay      # property not sampled in 512 tries: plain random


def _key(p):
    """(channel, payload bytes) of a decoded GatewayPacket — the PDU
    layout is [len, hdr, hdr, payload..., crc, crc, flags]
    (core/codec.decode; reference PDU framing)."""
    plen = int(p.result.payload[0])
    return (p.channel, bytes(p.result.payload[3:3 + plen]))


def run_gateway_soak(gw, channels, sfs, chunks, chunk_samples, seed=0,
                     duty_target=0.08, collision_every=7, progress=None,
                     noise_sigma=0.005, inject_log=None,
                     curated: bool | None = None):
    """Stream ``chunks`` x ``chunk_samples`` of synthetic air through
    ``gw``, injecting single packets (round-robin channel x SF) at
    ~``duty_target`` occupancy plus a golden two-packet collision every
    ``collision_every``-th injection.  Returns (expected, got,
    per_chunk_stats) where expected and got map
    (channel, payload bytes) -> count.

    ``curated`` selects the traffic class: True streams repeat-free
    payloads (the class the reference engine decodes by construction —
    the parity variant for ``split_repeats=False`` gateways); False
    streams uncurated traffic with every merged-track landmine class
    deliberately seeded (_uncurated_payload — the product-config soak).
    Default (None): uncurated iff the gateway runs ``split_repeats``."""
    if curated is None:
        curated = not getattr(gw, "_split_repeats", False)
    rng = np.random.default_rng(seed)
    ncfg = {sf: gw.sf_states[sf].cfg for sf in sfs}
    expected: dict = {}
    got: dict = {}
    stats_log = []
    carry = [[] for _ in range(channels)]   # (waveform, chunk offset) spill
    #: Absolute next-injection time per channel — persists ACROSS chunk
    #: boundaries so schedules never overlap by accident (every collision
    #: in the stream is a deliberately-injected golden pair).
    cursor = np.full(channels, 512, np.int64)
    total = chunks * chunk_samples
    done = total + (1 << 40)      # sentinel: channel schedule exhausted
    inj = 0

    def place(iqc, ch, off, wave):
        """Add `wave` at chunk offset `off`, spilling past the boundary
        (a wave starting beyond this chunk defers whole, offset rebased
        to the next chunk)."""
        if off >= chunk_samples:
            carry[ch].append((wave, off - chunk_samples))
            return
        if off < 0:
            wave = wave[-off:]
            off = 0
        take = min(len(wave), chunk_samples - off)
        iqc[ch, off:off + take] += wave[:take]
        if take < len(wave):
            carry[ch].append((wave[take:], 0))

    for ci in range(chunks):
        lo = ci * chunk_samples
        hi = lo + chunk_samples
        iq = rng.normal(0, noise_sigma, (channels, chunk_samples, 2)) \
            .astype(np.float32)
        iqc = iq[..., 0] + 1j * iq[..., 1]
        # Packets spilled from the previous chunk boundary.
        for ch in range(channels):
            spill, carry[ch] = carry[ch], []
            for wave, off in spill:
                place(iqc, ch, off, wave)
        # Inject fresh packets at the duty target.
        while True:
            ch = int(np.argmin(cursor))
            if cursor[ch] >= hi:
                break
            sf = sfs[(inj // channels) % len(sfs)]
            cfg = ncfg[sf]
            n_ = cfg.num_samples
            pay = _pyramid_safe_payload(cfg, inj, ch, sf) if curated \
                else _uncurated_payload(cfg, inj, ch, sf, rng)
            wave = _pkt(cfg, pay, 0.2)
            start = int(cursor[ch])
            if start + len(wave) > total:
                # A packet that cannot finish on air is never injected —
                # the carry spill past the last chunk would silently
                # truncate it (half a packet is not a hygiene test).
                cursor[ch] = done
                continue
            expected[(ch, pay)] = expected.get((ch, pay), 0) + 1
            if inject_log is not None:
                inject_log.append((inj, ch, sf, start, pay))
            place(iqc, ch, start - lo, wave)
            tail = start + len(wave)
            if cfg.sf == 8 and inj % collision_every == collision_every - 1:
                # Follow the single with the EXACT golden SF8 collision
                # pair (tests/test_pyramid.py README fixture: payloads,
                # amplitudes, 16-symbol + fractional offset) — demanded
                # byte-exact like the singles.  The pair is pinned to its
                # proven operating point because the soak asserts
                # STREAMING hygiene; arbitrary-phase pairs probe the
                # <100 % Pyramid envelope instead (docs/BENCH.md
                # collision table — SIC territory, not streaming).
                g1pay = bytes([1, 2, 3, 4, 5, 6])
                g2pay = bytes([7] * 5)
                g1 = _pkt(cfg, g1pay, 0.2)
                g2 = _pkt(cfg, g2pay, 0.09)
                # Past the single's suppression span, so the pair gets its
                # OWN dispatch window (inside it, g2 would sit at the
                # window tail and truncate).
                sup = gw.sf_states[sf].suppress
                gstart = -(-(tail + sup + 4 * n_) // n_) * n_
                goff2 = gstart + 16 * n_ + 4 * n_ // 8 + 204
                if goff2 + len(g2) <= total:
                    expected[(ch, g1pay)] = expected.get((ch, g1pay), 0) + 1
                    expected[(ch, g2pay)] = expected.get((ch, g2pay), 0) + 1
                    place(iqc, ch, gstart - lo, g1)
                    place(iqc, ch, goff2 - lo, g2)
                    tail = goff2 + len(g2)
            gap = int(len(wave) / max(duty_target, 1e-3)
                      * (0.7 + 0.6 * rng.random()))
            cursor[ch] = tail + gap + int(rng.integers(0, n_))
            inj += 1
        for p in gw.feed(to_ri(iqc)):
            if p.result is not None and p.result.ok and p.result.crc_ok:
                got[_key(p)] = got.get(_key(p), 0) + 1
        s = gw.stats()
        s["recent"] = max(len(st.recent) for st in gw.sf_states.values())
        s["ring_cap"] = gw._ring.cap
        s["ring_len"] = gw._ring.length
        stats_log.append(s)
        if progress is not None:
            progress(ci, s)
    for p in gw.flush():
        if p.result is not None and p.result.ok and p.result.crc_ok:
            got[_key(p)] = got.get(_key(p), 0) + 1
    return expected, got, stats_log


def check_soak(expected, got, stats_log, gw, min_packets,
               max_duty=1.5):
    """The hygiene assertions (module doc) — raise AssertionError on any
    violation; shared verbatim by the test and the bench."""
    assert sum(expected.values()) >= min_packets, sum(expected.values())
    # Byte-exact PDUs throughout: every injected packet — singles AND
    # both members of each golden collision pair — decodes exactly once,
    # and nothing decodes that was not injected.
    missing = {k: v for k, v in expected.items() if got.get(k, 0) < v}
    dupes = {k: (got[k], expected.get(k, 0)) for k in got
             if got[k] > expected.get(k, 0)}
    phantom = {k for k in got if k not in expected}
    assert not missing, (len(missing), sorted(missing)[:4])
    assert not dupes, dupes
    assert not phantom, phantom
    # Bounded streaming state at every sampled point.
    for s in stats_log:
        assert s["recent"] <= 4096 + 64, s["recent"]
        assert s["pending_events"] <= 64, s["pending_events"]
        assert s["dropped_events"] == 0, s["dropped_events"]
        assert s["device_deviations"] == 0, s["device_deviations"]
    # The ring must settle: capacity stops growing after warm-up and the
    # live span stays far below the total streamed length (trim works).
    caps = [s["ring_cap"] for s in stats_log]
    assert caps[-1] == caps[len(caps) // 2], caps
    assert stats_log[-1]["ring_len"] <= caps[-1]
    # Dispatch stayed event-driven: duty reflects the injected occupancy
    # (each event pays a fixed window ~4x its packet span, so small-scale
    # runs sit well above the raw duty target), not wholesale dispatching.
    assert stats_log[-1]["duty_cycle"] < max_duty, stats_log[-1]
