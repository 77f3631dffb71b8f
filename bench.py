#!/usr/bin/env python
"""Benchmark: Pyramid collision-decoder throughput on one GPU.

The reference's headline performance claim is *real-time* collision decoding
(reference README.md:2): its hot loop runs two zero-padded FFTs plus a peak
scan per hop (hop = symbol/8, pyramid_demod_impl.cc:569-603) and keeps up
with a fs = 2*bw = 250 ksps stream on a desktop CPU.  This bench runs the
same dense computation — Kaiser-windowed + unwindowed zoom-DFT spectra of
every overlapped dechirped frame, folded and peak-reduced — as batched
matmuls on the GPU and reports IQ samples/s.  Other modes (--mode) time the
gateways end to end, per SF lattice backends, and the PER and collision
envelopes.

vs_baseline = samples/s divided by the reference's 250 ksps real-time rate.

Prints one JSON line to stdout; refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_inputs(cfg, num_frames: int, seed: int = 0,
                 noise: float = 0.05, amp: float = 1.0):
    import jax.numpy as jnp

    from gr_lora_tpu.config import PYRAMID_OVERLAP_FACTOR
    from gr_lora_tpu.core.codec import encode
    from gr_lora_tpu.models.modulator import modulate
    from gr_lora_tpu.ops.cplx import to_ri

    n = cfg.num_samples
    hop = n // PYRAMID_OVERLAP_FACTOR
    total = num_frames * hop + n
    rng = np.random.default_rng(seed)
    iq = rng.normal(0.0, noise, (total, 2)).astype(np.float32)
    pkt = amp * to_ri(modulate(encode(bytes(range(1, 7)), cfg), cfg,
                               pad_front=0, pad_back=0))
    step = max(total // 4, 1)
    for off in range(0, max(total - len(pkt), 1), step):
        iq[off:off + len(pkt)] += pkt
    return jnp.asarray(iq), hop, total


def make_step(cfg, num_frames: int, backend: str = "xla"):
    """iq [T, 2] -> per-hop folded peak (idx, val, val_w): the full dense
    pyramid front-end with the output reduced on-device."""
    import jax
    import jax.numpy as jnp

    from gr_lora_tpu.models.pyramid import lattice_spectra

    spectra = lattice_spectra(cfg, num_frames, backend)

    def step(iq):
        fft_add, fft_add_w, h_single = spectra(iq)
        return (jnp.argmax(fft_add_w, -1).astype(jnp.int32),
                jnp.max(fft_add_w, -1), jnp.max(fft_add, -1),
                jnp.max(h_single, -1))

    return jax.jit(step)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="smoke test")
    ap.add_argument("--sf", type=int, default=8)
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--fft-factor", type=int, default=2)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    # Matmul precision of the zoom-DFT (config.LoraConfig.precision).
    # f32 by default: on the H100, TF32 ('default') lost 2 of 10 SF12
    # singles of the north-star fixture that f32 decodes, at the same
    # SF12 lattice wall (PERF.md).
    ap.add_argument("--precision", choices=["highest", "default", "bf16"],
                    default="highest")
    ap.add_argument("--mode",
                    choices=["pyramid", "gateway", "scan", "lattice",
                             "pyramid_gateway", "per", "collision",
                             "north_star", "soak"],
                    default="pyramid",
                    help="pyramid: dense collision front-end; gateway: "
                         "vmapped demod FSM over many channels; scan: "
                         "detection-gated preamble sweep (all SFs); "
                         "lattice: per-SF time of each lattice backend at "
                         "the north-star window shapes; "
                         "pyramid_gateway: end-to-end multi-channel "
                         "collision decoding incl. host tracker time; "
                         "per: PER-vs-SNR curve artifact -> docs/; "
                         "north_star: 64 channels x SF7-12 detection-gated "
                         "collision gateway end-to-end with wall split; "
                         "soak: sustained-air streaming-state hygiene "
                         "(>= 30 simulated minutes, dist/soak assertions)")
    ap.add_argument("--minutes", type=float, default=31.0,
                    help="soak: simulated air minutes per channel")
    ap.add_argument("--sfs", type=str, default=None,
                    help="comma-separated SF list (north_star / lattice / "
                         "pyramid_gateway multi-SF)")
    ap.add_argument("--trials", type=int, default=None,
                    help="per mode: trials per (sf, snr) point")
    ap.add_argument("--channels", type=int, default=None,
                    help="channel count (default: 64 for north_star — the "
                         "BASELINE.md configuration — 2 for soak, else 16)")
    ap.add_argument("--backend", choices=["xla", "fast"], default=None,
                    help="lattice spectra formulation (models/pyramid"
                         ".LATTICE_BACKENDS: 'xla' = direct zoom-DFT "
                         "matmul below its size cap, 'fast' = overlap "
                         "decomposition).  Default: the gateway's own "
                         "(dist/collision_gateway.DEFAULT_BACKEND)")
    ap.add_argument("--scan-precision",
                    choices=["highest", "default", "bf16"], default="bf16",
                    help="north_star: matmul precision of the dense "
                         "detection scan only (argmax + dominance gate "
                         "tolerate bf16); the extraction lattice keeps "
                         "--precision")
    ap.add_argument("--event-batch", type=int, default=8,
                    help="north_star: windows per lattice/tracker batch "
                         "(vmap lanes; larger amortizes the device "
                         "tracker's sequential hop scan)")
    ap.add_argument("--sic", action="store_true",
                    help="north_star: opt-in successive interference "
                         "cancellation on decoded windows "
                         "(TriggeredPyramidGateway(sic=True)); its wall "
                         "cost is reported in the split")
    ap.add_argument("--sic-gate", default=0.02,
                    type=lambda s: None if s.lower() == "none"
                    else float(s),
                    help="north_star --sic: residual-energy fraction "
                         "above which a window runs the full "
                         "subtract-and-re-read loop ('none' = "
                         "unconditional full loop; see "
                         "dist/collision_gateway)")
    ap.add_argument("--tracker", choices=["host", "device"], default="host",
                    help="pyramid_gateway / north_star: peak tracking on "
                         "the host (native C++ bank, lattice fetched) or "
                         "on-device (models/device_tracker — only finished "
                         "packets leave the device)")
    args = ap.parse_args()

    from gr_lora_tpu import LoraConfig
    from gr_lora_tpu.dist.collision_gateway import DEFAULT_BACKEND
    from gr_lora_tpu.runtime import enable_compile_cache, require_gpu

    require_gpu("bench.py")
    enable_compile_cache()

    if args.channels is None:
        # Per-mode defaults (an explicit --channels always wins): soak
        # runs 2 channels x >= 30 simulated minutes.
        args.channels = {"north_star": 64, "soak": 2}.get(args.mode, 16)
    args.backend = args.backend or DEFAULT_BACKEND

    # threshold=5.0 is the reference collision flowgraph's operating value
    # (rx_file_collision.grc); the spectra-only steps ignore it, the peak
    # lattices gate their top-M on it.
    cfg = LoraConfig(sf=args.sf, cr=1, crc=True, ldr=False,
                     explicit_header=False, payload_len=6,
                     p=args.p, fft_factor=args.fft_factor,
                     precision=args.precision, threshold=5.0)
    num_frames = args.frames or (256 if args.quick else 16384)
    iters = args.iters or (2 if args.quick else 20)

    if args.mode == "gateway":
        return bench_gateway(cfg, args)
    if args.mode == "scan":
        return bench_scan(cfg, args)
    if args.mode == "lattice":
        return bench_lattice(args)
    if args.mode == "pyramid_gateway":
        return bench_pyramid_gateway(args)
    if args.mode == "north_star":
        return bench_north_star(args)
    if args.mode == "per":
        return bench_per(args)
    if args.mode == "collision":
        return bench_collision(args)
    if args.mode == "soak":
        return bench_soak(args)

    import jax

    iq, hop, total = build_inputs(cfg, num_frames)
    step = make_step(cfg, num_frames, args.backend)

    # Warm up (compile), then the best of three timed rounds.
    jax.block_until_ready(step(iq))
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step(iq)
        jax.block_until_ready(out)
        dt = min(dt, time.perf_counter() - t0)

    samples = num_frames * hop * iters
    sps = samples / dt
    baseline_sps = 2 * 125e3            # reference real-time rate: fs = 2*bw
    line = {
        "metric": "pyramid_dense_frontend_throughput",
        "value": round(sps, 1),
        "unit": "samples/s",
        "vs_baseline": round(sps / baseline_sps, 2),
    }
    if not args.quick:
        # The full north-star fixture, 2 of the usual 4 timed iterations,
        # nested in the same line; a failure there fails the run.
        import copy
        ns_args = copy.copy(args)
        ns_args.channels = 64
        ns_args.iters = 2
        ns = bench_north_star(ns_args, emit=False)
        line["north_star"] = {
            "x_realtime_per_channel": round(ns["x_realtime_per_channel"], 2),
            "channels": ns["channels"],
            "sfs": ns["sfs"],
            "note": "full fixture, 2 timed iterations "
                    "(4: --mode north_star)",
        }
    print(json.dumps(line))
    dev = jax.devices()[0]
    print(f"# device={dev.device_kind} sf={cfg.sf} p={cfg.p} "
          f"precision={cfg.precision} backend={args.backend} "
          f"fft_factor={cfg.fft_factor} frames/iter={num_frames} hop={hop} "
          f"iters={iters} wall={dt:.3f}s", file=sys.stderr)


def per_point(cfg, snr_db, trials, seed, weak=False):
    """PER at one (config, in-band SNR) point: `trials` independent AWGN
    realizations of one packet, demodulated as ONE vmapped batch.

    SNR is in-band (over bw, the Semtech convention): complex noise of
    per-component std ``amp*sqrt(p/(2*snr))`` puts 1/p of its power in
    band at fs = p*bw.
    """
    import jax
    import jax.numpy as jnp

    from gr_lora_tpu.core.codec import decode, encode
    from gr_lora_tpu.models.demodulator import demod_fn
    from gr_lora_tpu.models.modulator import modulate
    from gr_lora_tpu.models.weak import (modulate_weak, weak_demod_fn,
                                         weak_packet_duration)
    from gr_lora_tpu.ops.cplx import to_ri

    payload = bytes(range(1, 1 + cfg.payload_len))
    tx_syms = encode(payload, cfg)
    if weak:
        cfg = cfg.replace(weak_sym_num=len(tx_syms))
        clean = modulate_weak(tx_syms, cfg)
        fn = jax.jit(jax.vmap(weak_demod_fn(cfg, len(clean), 2)))
    else:
        clean = modulate(tx_syms, cfg)
        fn = jax.jit(jax.vmap(demod_fn(cfg, len(clean), 2)))
    amp = 1.0
    sigma = amp * np.sqrt(cfg.p * 10.0 ** (-snr_db / 10.0) / 2.0)
    rng = np.random.default_rng(seed)
    noise = sigma * (rng.standard_normal((trials, len(clean)))
                     + 1j * rng.standard_normal((trials, len(clean))))
    batch = to_ri((clean[None, :] + noise).astype(np.complex64))
    outs = jax.device_get(fn(jnp.asarray(batch)))
    if weak:
        syms, lens, cnt, _ = (np.asarray(x) for x in outs)
    else:
        syms, lens, _, cnt, _, _ = (np.asarray(x) for x in outs)
    ok = 0
    for t in range(trials):
        for r in range(int(cnt[t])):
            res = decode(syms[t, r, :lens[t, r]], cfg)
            if res.ok and (res.crc_ok or not cfg.crc) and \
                    bytes(res.payload[:len(payload)]) == payload:
                ok += 1
                break
    return 1.0 - ok / trials


# Anchors for the measured waterfalls (VERDICT r2 #6).  Two independent
# references:
#  - Semtech SX127x demodulator SNR ladder (datasheet "SNR = -7.5 dB at
#    SF7, 2.5 dB per SF": sensitivity minus the -117 dBm thermal floor at
#    125 kHz/NF 6 dB) — what production silicon achieves at ~1 % PER.
#  - The IDEAL non-coherent bound computed below — dechirp + magnitude
#    argmax IS non-coherent 2^sf-ary orthogonal signaling, so a perfectly
#    synchronized receiver's SER has a closed form; no receiver can sit
#    below it.
_SEMTECH_SNR_DB = {7: -7.5, 8: -10.0, 9: -12.5, 10: -15.0, 11: -17.5,
                   12: -20.0}
# Measured detection overhead vs the silicon ladder (docs/BENCH.md anchor
# table): 4-consecutive-argmax packet detection + hard-decision decode at
# PACKET-perfect PER=0.5 costs <= ~4 dB at low SF, and BEATS the ladder at
# SF >= 10.  The assertion band encodes that envelope.
_ANCHOR_TOL_ABOVE_DB = 4.5
_ANCHOR_TOL_BELOW_IDEAL_DB = 1.0
# Weak-path band (VERDICT r3 task 7, tightened r5 per VERDICT r4 task 8):
# measured overhead of the integrator-free weak chain vs the 2-copy ideal
# bound — preamble/SFD detection at 6 combined chirps plus fractional-bin
# rounding of the combined argmax.  Recorded PER-SF from the r5 100-trial
# regeneration (docs/BENCH.md anchor table) and banded at measured
# + 1.5 dB trial jitter, so a >= 2 dB weak-chain sensitivity regression
# fails the assert (the old uniform 7 dB band could not catch one).  The
# "reference" compensation policy is only lower-bounded: its modulus-1
# random walk (a replicated reference landmine) has no physics ceiling.
# At the LDR SFs the recorded "weak" curve IS the (identical) policy pair
# and sits below every swept point (waterfall None) — no margin to record.
# r5 100-trial regeneration: measured 5.47 / 4.99 / 4.36 / 3.50 dB.
_WEAK_LDRONLY_MARGIN_DB = {7: 5.5, 8: 5.0, 9: 4.4, 10: 3.5}
_WEAK_TOL_SLACK_DB = 1.5


def ideal_per_waterfall(sf: int, nsym: int, per: float = 0.5,
                        samples: int = 400_000, seed: int = 0,
                        copies: int = 1) -> float:
    """In-band SNR (dB) where an IDEAL receiver reaches packet-error
    ``per`` over ``nsym`` uncoded symbols.

    Dechirped LoRa symbol detection is non-coherent M-ary orthogonal
    signaling (M = 2^sf): correct iff the signal bin's magnitude beats all
    M-1 Exp(1) noise bins, so SER(g) = 1 - E[(1 - exp(-S))^(M-1)] with
    S = |sqrt(g) + CN(0,1)|^2 and g = Es/N0 = SNR_inband * 2^sf.  The
    expectation is a 1-D integral, evaluated here by a fixed-seed Monte
    Carlo over S (~1e-3 absolute accuracy).  Idealizations: perfect
    sync/CFO, no coding, no fold penalty — a strict lower bound for the
    real chain.

    ``copies=2`` is the weak-demod anchor (VERDICT r3 task 7): the weak
    waveform carries every symbol twice and the receiver combines both
    windows non-coherently before the argmax (models/weak.py;
    reference weak_demod_impl.cc:172-194).  The bound uses square-law
    (power-sum) combining — the OPTIMAL non-coherent diversity combiner —
    so it lower-bounds the implemented magnitude-sum receiver too: the
    signal statistic is noncentral-chi^2 with 2*copies DoF and the M-1
    noise bins are Gamma(copies, 1), with CDF
    P(N < s) = 1 - exp(-s) * sum_{j<copies} s^j/j!.  SNR stays the
    per-symbol-PERIOD in-band SNR, so the ~3 dB combining gain vs
    ``copies=1`` at equal SNR is exactly the doubled on-air energy."""
    import math

    m = (1 << sf) - 1
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((copies, samples)) * np.sqrt(0.5)
    y = rng.standard_normal((copies, samples)) * np.sqrt(0.5)
    ser_target = 1.0 - (1.0 - per) ** (1.0 / nsym)

    def ser(snr_db: float) -> float:
        g = 10.0 ** (snr_db / 10.0) * (1 << sf)
        s = np.sum((np.sqrt(g) + x) ** 2 + y ** 2, axis=0)
        # Gamma(copies,1) upper tail at s; (1-tail)^m via log1p for
        # numerical stability at large s.
        tail = np.exp(-s) * sum(s ** j / math.factorial(j)
                                for j in range(copies))
        return float(1.0 - np.mean(np.exp(m * np.log1p(-tail))))

    lo, hi = -40.0, 10.0
    for _ in range(40):
        mid = (lo + hi) / 2
        if ser(mid) > ser_target:
            lo = mid
        else:
            hi = mid
    return round((lo + hi) / 2, 2)


def _per_waterfall(points):
    """Interpolated SNR at PER = 0.5 from a sorted [(snr, per), ...]."""
    pts = sorted(points)
    for (s0, p0), (s1, p1) in zip(pts, pts[1:]):
        if p0 >= 0.5 >= p1:
            if p0 == p1:
                return s0
            return s0 + (p0 - 0.5) * (s1 - s0) / (p0 - p1)
    return None


def _write_per_artifact(args, curves, anchors=None):
    import os

    import jax

    os.makedirs("docs", exist_ok=True)
    artifact = {"device": jax.devices()[0].device_kind, "p": args.p,
                "precision": args.precision, "curves": curves}
    if anchors:
        artifact["anchors"] = anchors
    # Atomic: this is the long sweep's checkpoint — a kill mid-dump must
    # not destroy the curves already collected.
    tmp = "docs/per_curves.json.tmp"
    with open(tmp, "w") as f:
        json.dump(artifact, f, indent=1)
    os.replace(tmp, "docs/per_curves.json")


def bench_per(args):
    """PER-vs-SNR curves (plain FSM + weak demod), SF7-SF12, written to
    docs/per_curves.json; reports the SF8 waterfall vs the -13.5 dB ideal
    demodulation bound (BASELINE.md weak-demod row)."""
    import jax

    from gr_lora_tpu import LoraConfig

    trials = args.trials or (6 if args.quick else 100)
    sfs = (7, 8) if args.quick else (7, 8, 9, 10, 11, 12)
    curves = {}
    t0 = time.perf_counter()
    for sf in sfs:
        ldr = (1 << sf) / 125e3 > 16e-3
        cfg = LoraConfig(sf=sf, cr=1, crc=True, ldr=ldr,
                         explicit_header=False, payload_len=8, p=args.p,
                         fft_factor=4, precision=args.precision)
        # Waterfalls sit near the Semtech sensitivity ladder
        # (~ -6 - 2.5*(sf-7) dB demod SNR); sweep around it.
        center = -7.5 - 2.5 * (sf - 7)
        snrs = [round(center + d, 1) for d in
                (-4.0, -3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 4.0, 6.0)]
        # Weak demod needs the GRC-default fine zoom (fft_factor=8): its
        # modulus-1 drift compensator misfires on coarse-bin quantization.
        # At sf >= 9 ff=4 keeps the zoom-DFT weight constants small and
        # is validated clean (bins are absolutely finer at high SF, so
        # the compensator holds).
        weak_cfg = cfg.replace(fft_factor=8 if sf < 9 else 4)
        # Both weak_compensation policies are recorded against the 2-copy
        # ideal bound (VERDICT r3 task 7).  At ldr (sf >= 11) the policies
        # are identical by definition (modulus-4 integrator applies either
        # way, config.py) — the second sweep would duplicate the first.
        variants = [("plain", None, 0.0),
                    # "reference" reproduces weak_demod_impl.cc:196-217:
                    # the always-on modulus-1 drift integrator random-walks
                    # on noisy fractional bins, so PACKET-perfect SNR is
                    # higher — sweep a range shifted up, not down.
                    ("weak", "reference", 6.0)]
        if not ldr:
            variants.append(("weak_ldronly", "ldr-only", 2.0))
        for name, policy, shift in variants:
            weak = policy is not None
            key = f"sf{sf}_{name}"
            pts = []
            vcfg = cfg if not weak else \
                weak_cfg.replace(weak_compensation=policy)
            sweep = snrs if not weak else sorted(
                {round(s + shift, 1) for s in snrs}
                | {round(center + shift + d, 1) for d in (-6.0, -5.0)})
            for snr in sweep:
                per = per_point(vcfg, snr, trials,
                                seed=hash((sf, snr, weak)) % (1 << 31),
                                weak=weak)
                pts.append((snr, per))
            curves[key] = {
                "snr_db": [s for s, _ in pts],
                "per": [p for _, p in pts],
                "trials": trials,
                "waterfall_db": _per_waterfall(pts),
            }
            print(f"# {key}: waterfall={curves[key]['waterfall_db']} "
                  f"{pts}", file=sys.stderr)
            _write_per_artifact(args, curves)   # incremental (long run)
    dt = time.perf_counter() - t0
    dev = jax.devices()[0]

    # Anchor check (VERDICT r2 #6): every plain waterfall must sit between
    # the ideal non-coherent bound (physics) and the Semtech SX127x ladder
    # plus the documented detection overhead.  Quick runs are too noisy to
    # gate on (6 trials -> +-2 dB waterfall jitter); they only report.
    from gr_lora_tpu.core.header import calc_sym_num
    anchors = {}
    for sf in sfs:
        key = f"sf{sf}_plain"
        wf = curves.get(key, {}).get("waterfall_db")
        if wf is None:
            continue
        ldr = (1 << sf) / 125e3 > 16e-3
        nsym = calc_sym_num(8, sf=sf, cr=1, crc=True, ldr=ldr,
                            explicit_header=False)
        ideal = ideal_per_waterfall(sf, nsym)
        semtech = _SEMTECH_SNR_DB[sf]
        anchors[key] = {"ideal_db": ideal, "semtech_db": semtech,
                        "measured_db": wf,
                        "vs_semtech_db": round(wf - semtech, 2)}
        if not args.quick and trials >= 30:
            assert wf >= ideal - _ANCHOR_TOL_BELOW_IDEAL_DB, \
                f"{key}: measured {wf} beats the ideal bound {ideal}" \
                " — measurement bug (check noise calibration)"
            assert wf <= semtech + _ANCHOR_TOL_ABOVE_DB, \
                f"{key}: measured {wf} vs Semtech {semtech} exceeds the" \
                f" {_ANCHOR_TOL_ABOVE_DB} dB detection-overhead band"
        # Weak path (VERDICT r3 task 7): band-assert against the 2-copy
        # non-coherent combining bound.  Only the integrator-free chain
        # ("ldr-only" at !ldr; at ldr both policies coincide and the
        # recorded "weak" key IS integrator-modulus-4) gets the upper
        # band — the replicated reference random walk has no ceiling.
        ideal_weak = ideal_per_waterfall(sf, nsym, copies=2)
        for name in ("weak", "weak_ldronly"):
            k2 = f"sf{sf}_{name}"
            wfw = curves.get(k2, {}).get("waterfall_db")
            if wfw is None:
                continue
            anchors[k2] = {"ideal_db": ideal_weak, "measured_db": wfw,
                           "vs_ideal_db": round(wfw - ideal_weak, 2)}
            if not args.quick and trials >= 30:
                assert wfw >= ideal_weak - _ANCHOR_TOL_BELOW_IDEAL_DB, \
                    f"{k2}: measured {wfw} beats the 2-copy ideal bound" \
                    f" {ideal_weak} — measurement bug"
                if name == "weak_ldronly" or ldr:
                    # Recorded per-SF margin + slack; SFs without a
                    # recorded margin (the LDR SFs, whose waterfall is
                    # normally unresolvable — PER 0 across the sweep)
                    # keep the old coarse 7 dB band as a backstop.
                    margin = _WEAK_LDRONLY_MARGIN_DB.get(sf, 5.5)
                    band = margin + _WEAK_TOL_SLACK_DB
                    assert wfw <= ideal_weak + band, \
                        f"{k2}: measured {wfw} vs 2-copy ideal" \
                        f" {ideal_weak} exceeds the {margin} dB margin" \
                        f" + {_WEAK_TOL_SLACK_DB} dB slack band"
    if anchors:
        _write_per_artifact(args, curves, anchors)
        print(f"# anchors: {json.dumps(anchors)}", file=sys.stderr)

    wf8 = curves.get("sf8_plain", {}).get("waterfall_db")
    print(json.dumps({
        "metric": "per_sf8_waterfall",
        "value": wf8 if wf8 is not None else -99.0,
        "unit": "dB in-band SNR at PER=0.5",
        # vs the documented -13.5 dB SF8 demod bound (BASELINE.md).
        "vs_baseline": round(wf8 / -13.5, 2) if wf8 is not None else 0.0,
    }))
    print(f"# device={dev.device_kind} mode=per trials={trials} "
          f"sfs={sfs} wall={dt:.1f}s -> docs/per_curves.json",
          file=sys.stderr)


def bench_soak(args):
    """Sustained-air soak (VERDICT r3 task 8): >= ``--minutes`` simulated
    minutes of air PER CHANNEL streamed through the detection-gated
    gateway in chunks, with the SAME hygiene assertions as
    tests/test_soak.py (gr_lora_tpu/dist/soak.check_soak): byte-exact
    PDUs throughout (singles and golden collision pairs, exactly once),
    bounded dedupe/pending/dispatch state, ring capacity settled, zero
    dropped events and device deviations.  The gateway runs the product
    config (split_repeats=True), so the traffic is UNCURATED (VERDICT r4
    weak #1): random payloads with every merged-track landmine class
    deliberately seeded (dist/soak._uncurated_payload).  The reference
    holds a GR stream open indefinitely (lib/demod_impl.cc:130) — this
    is the bounded-memory evidence at gateway duty."""
    import jax

    from gr_lora_tpu import LoraConfig
    from gr_lora_tpu.dist.collision_gateway import TriggeredPyramidGateway
    from gr_lora_tpu.dist.soak import check_soak, run_gateway_soak

    minutes = 3.0 if args.quick else args.minutes
    channels = args.channels
    sfs = tuple(int(s) for s in (args.sfs or "7,8").split(","))
    base = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                      payload_len=8, p=args.p, fft_factor=8, threshold=5.0,
                      precision=args.precision)
    # split_repeats (host trackers): merged-track landmines — adjacent
    # EQUAL symbols and adjacent-VALUE pairs bridged by leakage — are
    # deterministic truncations in reference-exact mode; the soak asserts
    # byte-exact streaming, so it runs the robust product config.
    gw = TriggeredPyramidGateway(base, channels, sfs=sfs,
                                 max_payload_len=8, backend=args.backend,
                                 tracker=args.tracker,
                                 event_batch=args.event_batch,
                                 split_repeats=True)
    gw.warmup()
    total = int(minutes * 60 * 125e3 * args.p)
    chunk = 1 << 22
    chunks = -(-total // chunk)
    t0 = time.perf_counter()

    def progress(ci, s):
        if ci % 16 == 15:
            print(f"# soak chunk {ci + 1}/{chunks} "
                  f"air={(ci + 1) * chunk / (125e3 * args.p) / 60:.1f} min "
                  f"pending={s['pending_events']} recent={s['recent']} "
                  f"ring_cap={s['ring_cap']} "
                  f"wall={time.perf_counter() - t0:.0f}s", file=sys.stderr)

    # noise_sigma 0.002 (~28 dB in-band for the singles): the soak
    # asserts byte-exact STREAMING over hundreds of packets, so it runs
    # with SNR headroom above the pyramid engine's ~1e-2 quantization
    # PER floor at arbitrary sub-symbol phases (docs/BENCH.md r4) —
    # sensitivity itself is --mode per / --mode collision territory.
    expected, got, log = run_gateway_soak(
        gw, channels, sfs, chunks, chunk, seed=11,
        duty_target=0.02, collision_every=3, progress=progress,
        noise_sigma=0.002)
    dt = time.perf_counter() - t0
    check_soak(expected, got, log, gw,
               min_packets=10 if args.quick else 100, max_duty=1.0)
    air_min = chunks * chunk / (125e3 * args.p) / 60
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "soak_air_minutes_clean",
        "value": round(air_min, 1),
        "unit": "simulated min/channel, all hygiene assertions passing",
        "vs_baseline": round(air_min / 30.0, 2),
    }))
    print(f"# device={dev.device_kind} mode=soak channels={channels} "
          f"sfs={sfs} packets_expected={sum(expected.values())} "
          f"packets_got={sum(got.values())} wall={dt:.1f}s "
          f"x_realtime={air_min * 60 / dt:.2f} "
          f"final={log[-1]}", file=sys.stderr)


def bench_collision(args):
    """Collision-recovery sweep: both-packet byte-exact recovery rate of
    the Pyramid decoder over a grid of overlap offsets x amplitude ratios,
    reference-exact trackers vs grace mode — written to
    docs/collision_recovery.json.  This quantifies the headline feature
    (the reference README shows ONE curated alignment; this measures the
    whole envelope)."""
    import os

    import jax

    from gr_lora_tpu import LoraConfig
    from gr_lora_tpu.core.codec import decode, encode
    from gr_lora_tpu.models.modulator import modulate
    from gr_lora_tpu.models.pyramid import pyramid_demodulate
    from gr_lora_tpu.models.sic import sic_demodulate

    cfg = LoraConfig(sf=args.sf, cr=1, crc=True, ldr=False,
                     explicit_header=True, payload_len=8, p=args.p,
                     fft_factor=8, threshold=5.0, precision=args.precision)
    n = cfg.num_samples
    pay1, pay2 = bytes([1, 2, 3, 4, 5, 6]), bytes([7] * 5)
    pdu1 = "0630f0010203040506050801"
    pdu2 = "053000" + "07" * 5 + "e76b01"
    p1 = modulate(encode(pay1, cfg), cfg, pad_front=0, pad_back=0)
    p2 = modulate(encode(pay2, cfg), cfg, pad_front=0, pad_back=0)

    # Offsets span one symbol of sub-symbol phase at a deep overlap (with a
    # +13-sample fractional part: real collisions have generic timing —
    # EXACT hop alignment, where both packets' peaks share windows, is the
    # measure-zero degenerate case and is probed separately), plus coarse
    # overlap depths; ratios span strong/weak balance.
    noffs = 8 if args.quick else 16
    phases = [16 * n + (i * n) // noffs + 13 for i in range(noffs)]
    aligned = [16 * n, 16 * n + n // 8]       # degenerate hop-aligned probes
    depths = [8 * n, 12 * n, 16 * n, 20 * n] if not args.quick else [16 * n]
    ratios = [0.45, 0.3, 0.2] if not args.quick else [0.45]
    grid = {}
    t0 = time.perf_counter()
    # Three decoder tiers over the SAME grid: reference-exact trackers
    # (grace 0), grace mode, and SIC (models/sic — subtract-and-re-read;
    # beyond-reference, VERDICT r2 item 5).
    for label, run in (
        ("grace0", lambda iq: pyramid_demodulate(iq, cfg, grace=0)),
        ("grace8", lambda iq: pyramid_demodulate(iq, cfg, grace=8)),
        ("sic", lambda iq: [q.symbols for q in
                            sic_demodulate(iq, cfg, grace=8)]),
    ):
        results = {}
        for ratio in ratios:
            for depth_kind, offs in (("phase", [1000 + o for o in phases]),
                                     ("aligned", [1000 + o for o in aligned]),
                                     ("depth", [1000 + d + 204
                                                for d in depths])):
                both = 0
                strong = 0
                # Fixed buffer length across the whole grid: ONE compiled
                # lattice instead of one per distinct offset.
                total_fixed = max(phases + aligned + [d + 204 for d in depths]) \
                    + 1000 + len(p2) + 12 * n
                for off2 in offs:
                    total = total_fixed
                    iq = np.zeros(total, np.complex64)
                    iq[1000:1000 + len(p1)] += (0.2 * p1).astype(np.complex64)
                    iq[off2:off2 + len(p2)] += \
                        (0.2 * ratio * p2).astype(np.complex64)
                    pdus = {bytes(r.payload).hex() for r in
                            (decode(s, cfg) for s in run(iq))
                            if r.ok}
                    strong += pdu1 in pdus
                    both += (pdu1 in pdus) and (pdu2 in pdus)
                results[f"{depth_kind}_r{ratio}"] = {
                    "trials": len(offs), "strong": strong, "both": both}
        grid[label] = results
    dt = time.perf_counter() - t0

    dev = jax.devices()[0]
    artifact = {"device": dev.device_kind, "sf": cfg.sf, "p": cfg.p,
                "fft_factor": cfg.fft_factor, "grid": grid}
    if args.quick:
        # Smoke runs must not clobber the published full-grid artifact.
        print("# quick mode: artifact NOT written to docs/", file=sys.stderr)
    else:
        os.makedirs("docs", exist_ok=True)
        tmp = "docs/collision_recovery.json.tmp"
        with open(tmp, "w") as f:
            json.dump(artifact, f, indent=1)
        os.replace(tmp, "docs/collision_recovery.json")

    g0 = grid["grace0"]
    tot = sum(v["trials"] for v in g0.values())
    both0 = sum(v["both"] for v in g0.values())
    both8 = sum(v["both"] for v in grid["grace8"].values())
    boths = sum(v["both"] for v in grid["sic"].values())
    s0 = sum(v["strong"] for v in g0.values())
    ss = sum(v["strong"] for v in grid["sic"].values())
    print(json.dumps({
        "metric": "collision_both_recovery_rate_sic",
        "value": round(boths / tot, 3),
        "unit": "fraction of offset/ratio grid (SIC decoder)",
        "vs_baseline": round(both0 / tot, 3),   # reference-exact tier
    }))
    dest = "(not written: --quick)" if args.quick \
        else "-> docs/collision_recovery.json"
    print(f"# device={dev.device_kind} mode=collision grid={tot} points "
          f"strong_grace0={s0}/{tot} strong_sic={ss}/{tot} "
          f"both_grace0={both0}/{tot} both_grace8={both8}/{tot} "
          f"both_sic={boths}/{tot} wall={dt:.1f}s {dest}",
          file=sys.stderr)


def bench_pyramid_gateway(args):
    """End-to-end gateway-scale collision decoding: C channels of real
    two-packet collisions through the batched lattice AND the native
    per-channel trackers — wall clock includes peak fetch + tracker walk,
    i.e. the full product path of dist/pyramid_gateway.py."""
    import jax

    from gr_lora_tpu import LoraConfig
    from gr_lora_tpu.core.codec import encode
    from gr_lora_tpu.dist.pyramid_gateway import PyramidGateway
    from gr_lora_tpu.models.modulator import modulate
    from gr_lora_tpu.ops.cplx import to_ri

    # rx_file_collision.grc operating point (sf=8 ff=8 threshold=5),
    # times `channels`.
    cfg = LoraConfig(sf=args.sf, cr=1, crc=True, ldr=False,
                     explicit_header=True, payload_len=8, p=args.p,
                     fft_factor=8, threshold=5.0, precision=args.precision)
    n = cfg.num_samples
    channels = args.channels
    # Scale the block with channel count: the lattice materializes
    # [C, hops, ...] intermediates (~4 GB at 64ch x 2048 hops x ff=8).
    block_hops = 256 if args.quick else max(512, 2048 * 16 // channels)
    iters = args.iters or (2 if args.quick else 8)
    hop = n // 8
    block = block_hops * hop + (n - hop)

    p1 = 0.2 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg,
                        pad_front=0, pad_back=0)
    p2 = 0.09 * modulate(encode(bytes([7] * 5), cfg), cfg,
                         pad_front=0, pad_back=0)
    rng = np.random.default_rng(0)
    iq = (0.01 * (rng.standard_normal((channels, block))
                  + 1j * rng.standard_normal((channels, block)))
          ).astype(np.complex64)
    for c in range(channels):
        base = (1000 + c * 997) % max(block - len(p1) - 17 * n, 1)
        off2 = base + 16 * n + 4 * n // 8 + 204
        iq[c, base:base + len(p1)] += p1
        if off2 + len(p2) < block:
            iq[c, off2:off2 + len(p2)] += p2
    ri = to_ri(iq)

    if args.sfs:
        # Always-on multi-SF matrix (every cell densely, no gating):
        # per-SF block_hops shrink with SF so the [C, hops, bins]
        # intermediates stay inside a fixed HBM budget (docs/BENCH.md
        # memory table).
        from gr_lora_tpu.dist.pyramid_gateway import MultiSFPyramidGateway
        sfs = tuple(int(s) for s in args.sfs.split(","))
        bh = {sf: max(64, block_hops * (1 << args.sf) // (1 << sf))
              for sf in sfs}
        gw = MultiSFPyramidGateway(cfg, channels, sfs=sfs, block_hops=bh,
                                   max_peaks=8, backend=args.backend,
                                   tracker=args.tracker)
        mode_tag = f"pyramid_gateway_multisf sfs={sfs}"
    else:
        gw = PyramidGateway(cfg, channels, block_hops=block_hops,
                            max_peaks=8, backend=args.backend,
                            tracker=args.tracker)
        mode_tag = "pyramid_gateway"
    pkts = len(gw.feed(ri))         # warm-up: compile + first tracker walk
    gw.wall_reset()
    t0 = time.perf_counter()
    for _ in range(iters):
        pkts += len(gw.feed(ri))
    dt = time.perf_counter() - t0

    samples = channels * block_hops * hop * iters
    sps = samples / dt
    baseline_sps = 2 * 125e3
    print(json.dumps({
        "metric": "pyramid_gateway_throughput",
        "value": round(sps, 1),
        "unit": "samples/s",
        "vs_baseline": round(sps / baseline_sps, 2),
    }))
    dev = jax.devices()[0]
    w = gw.wall
    other = dt - sum(w.values())
    print(f"# device={dev.device_kind} mode={mode_tag} "
          f"channels={channels} sf={cfg.sf} p={cfg.p} backend={args.backend} "
          f"precision={cfg.precision} block_hops={block_hops} iters={iters} "
          f"packets={pkts} per_channel_x_realtime="
          f"{sps / channels / baseline_sps:.1f} wall={dt:.3f}s "
          f"split[dispatch={w['dispatch']:.3f} fetch={w['fetch']:.3f} "
          f"tracker={w['tracker']:.3f} decode={w['decode']:.3f} "
          f"host/other={other:.3f}]",
          file=sys.stderr)


def bench_north_star(args, emit=True):
    """The BASELINE.md north-star configuration end-to-end: 64 x 125 kHz
    channels x SF7-12 with Pyramid collision decoding, detection-gated
    (dist/collision_gateway.py).  Every channel carries the README golden
    two-packet collision plus a single packet at a round-robin SF per air
    window (gr_lora_tpu.fixtures.north_star_fixture); every iteration's
    PDUs are checked against that fixture before its rate counts.  The
    wall is split scan / lattice / tracker / decode so the bottleneck is
    visible.  vs_baseline = x real-time PER CHANNEL (the reference's 250
    ksps single-channel real-time claim, README.md:2,45).
    """
    import jax

    from gr_lora_tpu import LoraConfig
    from gr_lora_tpu.dist.collision_gateway import TriggeredPyramidGateway
    from gr_lora_tpu.fixtures import (check_pdus, north_star_fixture,
                                      pdu_counts)
    from gr_lora_tpu.ops.cplx import to_ri

    sfs = tuple(int(s) for s in (args.sfs or "7,8,9,10,11,12").split(","))
    channels = args.channels
    T = 1 << (17 if args.quick else 20)     # air window per iteration
    iters = args.iters or (1 if args.quick else 4)
    base = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                      payload_len=8, p=args.p, fft_factor=8, threshold=5.0,
                      precision=args.precision)
    gw = TriggeredPyramidGateway(base, channels, sfs=sfs,
                                 max_payload_len=16, backend=args.backend,
                                 tracker=args.tracker,
                                 event_batch=args.event_batch,
                                 scan_precision=args.scan_precision,
                                 sic=args.sic, sic_gate=args.sic_gate)
    iq, expected = north_star_fixture(
        {sf: st.cfg for sf, st in gw.sf_states.items()}, channels, T)
    # The fixture crosses the host->device link ONCE; iterations then feed
    # the device-resident copy (pipeline/device_ring.py).  wall['ingest']
    # stays visible for host-fed runs.
    ri = jax.device_put(to_ri(iq))

    # Warm-up: compile every (SF, batch-bucket) program up front, then
    # feed until every SF has scanned and dispatched at least once so the
    # streaming cadence (scan chunk boundaries, ring state) is warm too.
    gw.warmup()
    pkts = 0
    for _ in range(8):
        pkts += len(gw.feed(ri))
        if all(st.next_scan > 0 and st.dispatched
               for st in gw.sf_states.values()):
            break
    gw.wall_reset()
    d0 = gw.dispatched_samples
    t0 = time.perf_counter()
    got = []
    for _ in range(iters):
        got += gw.feed(ri)
    dt = time.perf_counter() - t0
    pkts += len(got)
    # Each iteration re-feeds the same air, so each expected PDU comes
    # back once per iteration that completed its windows.
    check = check_pdus(expected, pdu_counts(got))
    if check["missing"] or check["extra"]:
        raise SystemExit(f"north_star: PDUs missing {check['missing'][:8]} "
                         f"extra {check['extra'][:8]}")

    sps = channels * T * iters / dt
    per_ch = sps / channels / (2 * 125e3)
    w = gw.wall
    s = gw.stats()
    if emit:
        print(json.dumps({
            "metric": "north_star_gateway_throughput",
            "value": round(sps, 1),
            "unit": f"samples/s ({channels}ch x "
                    f"SF{'/'.join(map(str, sfs))}, "
                    "gated collision decoding)",
            "vs_baseline": round(per_ch, 2),
            "ingest": "device-resident",
        }))
    dev = jax.devices()[0]
    other = dt - sum(w.values())
    ls = gw.lattice_split
    print(f"# device={dev.device_kind} mode=north_star channels={channels} "
          f"sfs={sfs} p={args.p} backend={gw.backend} "
          f"precision={args.precision} T={T} iters={iters} packets={pkts} "
          f"per_channel_x_realtime={per_ch:.2f} "
          f"wall={dt:.3f}s split[ingest={w['ingest']:.3f} "
          f"scan={w['scan']:.3f} "
          f"lattice={w['lattice']:.3f} "
          f"(gather={ls['gather']:.3f} dispatch={ls['dispatch']:.3f} "
          f"fetch={ls['fetch']:.3f}) tracker={w['tracker']:.3f} "
          f"decode={w['decode']:.3f} sic={w['sic']:.3f} "
          f"host/other={other:.3f}] "
          f"dispatched={(gw.dispatched_samples - d0)} "
          f"duty={(gw.dispatched_samples - d0) / (channels * T * iters):.3f} "
          f"dropped_events={s['dropped_events']} "
          f"sic_windows={s['sic_windows']}", file=sys.stderr)
    return {"sps": sps, "x_realtime_per_channel": per_ch,
            "channels": channels, "packets": pkts,
            "sfs": "/".join(map(str, sfs)),
            "sic_windows": s["sic_windows"], "wall": dict(w)}


def bench_lattice(args):
    """Per-SF time of one dispatched lattice batch for each backend, at the
    north-star window shapes: ``event_batch`` lanes of ``win_hops`` hops,
    the gateway's own hop blocking and peak packing
    (TriggeredPyramidGateway._lattice).  The backends differ only where
    'xla' still runs the direct matmul (models/pyramid
    .lattice_formulation); above its size cap both run the overlap
    decomposition."""
    import jax
    import jax.numpy as jnp

    from gr_lora_tpu import LoraConfig
    from gr_lora_tpu.dist.collision_gateway import TriggeredPyramidGateway
    from gr_lora_tpu.models.pyramid import LATTICE_BACKENDS, \
        lattice_formulation

    sfs = tuple(int(s) for s in (args.sfs or "7,8,9,10,11,12").split(","))
    base = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                      payload_len=8, p=args.p, fft_factor=8, threshold=5.0,
                      precision=args.precision)
    reps = args.iters or 5
    rng = np.random.default_rng(0)
    dev = jax.devices()[0]
    table = {}
    for sf in sfs:
        row = {}
        for backend in LATTICE_BACKENDS:
            gw = TriggeredPyramidGateway(base, 1, sfs=(sf,),
                                         max_payload_len=16,
                                         event_batch=args.event_batch,
                                         backend=backend)
            st = gw.sf_states[sf]
            win = gw._win_samples(st)
            xs = jnp.asarray(rng.normal(
                0, 0.01, (args.event_batch, win, 2)).astype(np.float32))
            fn = gw._lattice(st)
            t0 = time.perf_counter()
            jax.block_until_ready(fn(xs))
            compile_s = time.perf_counter() - t0
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(xs))
                times.append(time.perf_counter() - t0)
            row[backend] = {
                "formulation": lattice_formulation(st.cfg, backend),
                "median_s": float(np.median(times)),
                "min_s": float(np.min(times)), "compile_s": compile_s}
            print(f"# sf={sf} backend={backend} "
                  f"({row[backend]['formulation']}) win_hops={st.win_hops} "
                  f"lanes={args.event_batch} "
                  f"block_hops={gw._lattice_block_hops(st)} "
                  f"median={row[backend]['median_s'] * 1e3:.3f} ms "
                  f"min={row[backend]['min_s'] * 1e3:.3f} ms "
                  f"first_call={compile_s:.1f} s", file=sys.stderr)
        table[sf] = row
    print(json.dumps({"metric": "lattice_batch_time_by_backend",
                      "device": dev.device_kind,
                      "precision": args.precision, "reps": reps,
                      "sfs": table}))
    return table


def bench_gateway(cfg, args):
    """Channel-parallel full demod-FSM throughput: C channels, each with
    real packets, vmapped over the batch axis on one chip."""
    import jax
    import jax.numpy as jnp

    from gr_lora_tpu.core.codec import encode
    from gr_lora_tpu.models.demodulator import demod_fn
    from gr_lora_tpu.models.modulator import modulate
    from gr_lora_tpu.ops.cplx import to_ri

    n = cfg.num_samples
    channels = args.channels
    num_syms = 96 if args.quick else 1024
    total = num_syms * n
    iters = args.iters or (2 if args.quick else 10)

    rng = np.random.default_rng(0)
    pkt = to_ri(modulate(encode(bytes(range(1, 7)), cfg), cfg,
                         pad_front=0, pad_back=0))
    iq = rng.normal(0.0, 0.05, (channels, total, 2)).astype(np.float32)
    for c in range(channels):
        off = int(rng.integers(0, max(total - len(pkt), 1)))
        iq[c, off:off + len(pkt)] += pkt
    iq = jnp.asarray(iq)

    fn = jax.jit(jax.vmap(demod_fn(cfg, total, 4)))
    jax.block_until_ready(fn(iq))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(iq)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0

    sps = channels * total * iters / dt
    baseline_sps = 2 * 125e3
    print(json.dumps({
        "metric": "gateway_demod_fsm_throughput",
        "value": round(sps, 1),
        "unit": "samples/s",
        "vs_baseline": round(sps / baseline_sps, 2),
    }))
    dev = jax.devices()[0]
    print(f"# device={dev.device_kind} mode=gateway channels={channels} "
          f"sf={cfg.sf} p={cfg.p} precision={cfg.precision} "
          f"fft_factor={cfg.fft_factor} total={total} iters={iters} "
          f"wall={dt:.3f}s", file=sys.stderr)


def bench_scan(cfg, args):
    """Idle-air cost of the detection-gated all-SF gateway: the dense
    preamble scan over channels x SFs (dist/triggered.py stage 1)."""
    import jax
    import jax.numpy as jnp

    from gr_lora_tpu.dist.triggered import make_preamble_scan

    channels = args.channels
    sfs = (7, 8, 9, 10, 11, 12)
    n7 = (1 << 7) * cfg.p
    t = (1024 if not args.quick else 96) * n7
    iters = args.iters or (2 if args.quick else 10)
    rng = np.random.default_rng(0)
    iq = jnp.asarray(rng.normal(0, 0.01, (channels, t, 2)).astype(np.float32))

    scans = []
    for sf in sfs:
        c = cfg.replace(sf=sf, ldr=(1 << sf) / 125e3 > 16e-3)
        scans.append(make_preamble_scan(c, t // c.num_samples, 8))

    def sweep(x):
        return [s(x) for s in scans]

    jax.block_until_ready(sweep(iq))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = sweep(iq)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0

    # Samples scanned per second, counted once per SF band processed.
    sps = channels * t * len(sfs) * iters / dt
    baseline_sps = 2 * 125e3
    print(json.dumps({
        "metric": "allsf_preamble_scan_throughput",
        "value": round(sps, 1),
        "unit": "samples/s",
        "vs_baseline": round(sps / baseline_sps, 2),
    }))
    dev = jax.devices()[0]
    print(f"# device={dev.device_kind} mode=scan channels={channels} "
          f"sfs={sfs} precision={cfg.precision} t={t} iters={iters} "
          f"wall={dt:.3f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
