"""Long-stream soak: streaming-state hygiene over sustained air.

VERDICT r3 task 8 / SURVEY §5 long-context row.  The reference receiver
holds an unbounded input stream open indefinitely (GR scheduler semantics,
lib/demod_impl.cc:130); our streaming state must survive the same regime
with BOUNDED host/device memory:

- ``st.recent`` dedupe map eviction (dist/collision_gateway._emit),
- ``st.pending`` / ``st.dispatched`` event lists,
- DeviceRing compaction/growth interplay with ``_trim`` across many wraps
  (byte-exact PDUs throughout prove window gathers never read stale or
  shifted samples),
- zero device-tracker deviations at nominal duty, and — driven to the
  bounded-pool limit on purpose — the documented delay-not-loss semantics
  (models/device_tracker module doc).

The default parameters keep the CPU-mesh runtime in CI range; the real
>= 30 simulated minutes per channel runs on the GPU via
``python bench.py --mode soak`` (same assertions, gateway scale).
"""

import os

import numpy as np
import pytest

from gr_lora_tpu import LoraConfig
from gr_lora_tpu.dist.collision_gateway import TriggeredPyramidGateway
from gr_lora_tpu.dist.soak import _pkt, check_soak, run_gateway_soak
from gr_lora_tpu.ops.cplx import to_ri

BASE = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                  payload_len=8, p=2, fft_factor=8, threshold=5.0)


def test_repeated_symbol_is_a_pyramid_landmine():
    """Documents a replicated REFERENCE limitation (SURVEY §7 landmine
    class): a payload whose encoding contains two adjacent equal symbols
    truncates in the Pyramid engine — the repeat merges into one
    over-long track that the classifier rejects as data
    (pyramid_demod_impl.cc:319-391, data tracks <= 2*overlaps) and the
    assembly walk stops at the resulting gap
    (pyramid_demod_impl.cc:680-767).  The plain FSM demodulator (windowed
    argmax, no tracking) decodes the same packet byte-exact — engine
    difference, not a bug.  The reference-parity soak variant
    (split_repeats=False) therefore streams repeat-free payloads
    (dist/soak._pyramid_safe_payload); the product config soaks
    UNCURATED traffic with this landmine class deliberately seeded
    (dist/soak._uncurated_payload, test_gateway_soak)."""
    from gr_lora_tpu.core.codec import decode, encode
    from gr_lora_tpu.models.pyramid import pyramid_demodulate
    from gr_lora_tpu.models.transceiver import loopback

    cfg = BASE
    pay = bytes([7, 0xA0, 8, 1, 2, 3, 4, 5])   # encodes ..., 2, 2, ...
    tx = np.asarray(encode(pay, cfg))
    assert np.any(tx[1:] == tx[:-1]), "fixture must contain a repeat"

    n = cfg.num_samples
    wave = 0.2 * _pkt(cfg, pay, 1.0)
    iq = np.zeros(8 * n + len(wave) + 30 * n, np.complex64)
    iq[8 * n:8 * n + len(wave)] += wave
    out = pyramid_demodulate(iq, cfg, max_peaks=8)
    assert len(out) == 1 and len(out[0]) < len(tx), \
        ("landmine no longer reproduces — update _pyramid_safe_payload",
         [len(s) for s in out])

    # The FSM demod path decodes the identical payload byte-exact.
    r = loopback(pay, cfg.replace(explicit_header=False, payload_len=8))
    d = r.decoded[0]
    assert d.ok and d.crc_ok and bytes(d.payload[:8]) == pay


@pytest.mark.parametrize("tracker", ["host", "device"])
def test_gateway_soak(tracker):
    """Minutes of simulated air through the detection-gated gateway in
    small chunks sized to force MANY DeviceRing trims/compactions; every
    PDU byte-exact, all streaming state bounded (module doc)."""
    channels = 2
    sfs = (7, 8)
    scale = int(os.environ.get("GR_LORA_SOAK_SCALE", "1"))
    gw = TriggeredPyramidGateway(BASE, channels, sfs=sfs,
                                 max_payload_len=8,
                                 tracker=tracker, use_native=False,
                                 scan_chunk_samples=1 << 15,
                                 split_repeats=True)
    n8 = gw.sf_states[8].cfg.num_samples
    chunk = 96 * n8
    chunks = (12 if tracker == "device" else 16) * scale
    expected, got, log = run_gateway_soak(
        gw, channels, sfs, chunks, chunk, seed=7,
        duty_target=0.18, collision_every=4)
    check_soak(expected, got, log, gw,
               min_packets=8 * scale if tracker == "device"
               else 12 * scale)
    # The stream really wrapped the device ring many times.
    streamed = chunks * chunk
    assert streamed > 4 * gw._ring.cap, (streamed, gw._ring.cap)
    # Product config => UNCURATED traffic: the landmine classes really
    # streamed (repeat-carrying payloads are exactly what split_repeats
    # exists to decode — VERDICT r4 weak #1).
    from gr_lora_tpu.core.codec import encode
    reps = 0
    for ch, pay in expected:
        sf = pay[2] if len(pay) == 8 else None      # uncurated tag layout
        if sf in sfs:
            tx = np.asarray(encode(pay, gw.sf_states[sf].cfg))
            reps += bool(np.any(tx[1:] == tx[:-1]))
    assert reps >= 2, (reps, sorted(expected))


def test_gateway_soak_reference_parity():
    """The split_repeats=False gateway is exact reference behavior, so its
    soak streams the curated repeat-free traffic class the reference
    engine decodes by construction (run_gateway_soak auto-selects it)."""
    channels = 2
    sfs = (7, 8)
    gw = TriggeredPyramidGateway(BASE, channels, sfs=sfs,
                                 max_payload_len=8,
                                 tracker="host", use_native=False,
                                 scan_chunk_samples=1 << 15,
                                 split_repeats=False)
    n8 = gw.sf_states[8].cfg.num_samples
    expected, got, log = run_gateway_soak(
        gw, channels, sfs, 8, 96 * n8, seed=9,
        duty_target=0.18, collision_every=4)
    check_soak(expected, got, log, gw, min_packets=6)


def test_device_tracker_deviation_delay_not_loss():
    """Drive the bounded finalize/expire pools into deliberate deviation
    (pool budgets of 1 under a collision's track churn) and assert the
    documented semantics: retirements are DELAYED to later hops, never
    dropped — the packet multiset equals the host tracker's output
    (models/device_tracker module doc 'a delay, not a loss')."""
    from gr_lora_tpu.models.device_tracker import DevicePyramidTracker
    from gr_lora_tpu.models.pyramid import (PyramidTracker,
                                            make_peak_lattice,
                                            num_hops_for)

    cfg = BASE.replace(beta=25.0)
    n = cfg.num_samples
    p1 = _pkt(cfg, bytes([1, 2, 3, 4, 5, 6]), 0.2)
    p2 = _pkt(cfg, bytes([7] * 5), 0.09)
    off2 = 1000 + 16 * n + 4 * n // 8 + 204
    iq = np.zeros(off2 + len(p2) + 30 * n, np.complex64)
    iq[1000:1000 + len(p1)] += p1
    iq[off2:off2 + len(p2)] += p2

    import jax
    iq_ri = np.ascontiguousarray(to_ri(iq), np.float32)
    nh = num_hops_for(cfg, iq_ri.shape[0])
    lat = tuple(np.asarray(x) for x in
                jax.device_get(make_peak_lattice(cfg, nh, 8)(iq_ri)))
    bins, h, hs, valid = lat

    host = PyramidTracker(cfg)
    for t in range(nh):
        v = valid[t]
        if v.any():
            order = np.argsort(bins[t][v], kind="stable")
            host.step(bins[t][v][order], h[t][v][order], hs[t][v][order])
        else:
            host.step()
    for _ in range(host.flush_hops()):
        host.step()
    want = sorted(s.tobytes() for s in host.symbols_out)
    assert len(want) >= 2

    dev = DevicePyramidTracker(cfg, max_peaks=8,
                               finalize_per_hop=1, expire_per_hop=1)
    dev.feed(*lat)
    # Delay-not-loss needs somewhere for the delays to land: generous
    # empty tail so every deferred retirement is applied.
    dev.feed_empty(4 * dev.flush_hops())
    syms, _ = dev.drain()
    assert dev.deviations() > 0, dev.stats()   # the pools really saturated
    assert sorted(s.tobytes() for s in syms) == want, (
        [list(s) for s in syms], dev.stats())
