#!/usr/bin/env python
"""Smoke run of the detection-gated multi-SF Pyramid gateway on the GPU.

    python chip_smoke.py          # one GPU: phases 1-4 below
    python chip_smoke.py --four   # four GPUs: the mesh gateways only

Phases, all in this one process (no child process opens the card):

1. device and environment: JAX's device, the card's name and power limit
   from ``nvidia-smi``, the JAX version, the compile cache, the native
   tracker library (required);
2. the peak lattice at SF7-12 (p=2, fft_factor=8) against the NumPy
   float64 reference (models/pyramid_ref), at ``highest`` precision (the
   gateway's) and at ``default`` (TF32);
3. the north star end to end: TriggeredPyramidGateway over 64 channels x
   SF7-12, 2^20 samples of air per channel, every golden collision PDU
   and every single PDU required exactly once;
4. the CLI: ``apps.gateway --collision`` on a seeded wideband capture at
   its default 8 channels x 1 Msps, every injected PDU exactly once.

``--four`` runs instead the north star on a 4-device ("ch",) mesh and the
``{ch: 2, t: 2}`` collision gateway, each against its one-device run.

A failed phase raises and the script exits non-zero.  Only when every
phase passed is the last stdout line the JSON object
``{"ok": true, "device": {...}}``.  Times printed here are smoke timings
from one run, not benchmark figures.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

SFS = (7, 8, 9, 10, 11, 12)
CHANNELS = 64
AIR = 1 << 20                   # samples per channel: 4.2 s at 250 ksps
LATTICE_HOPS = 48
MAX_PEAKS = 8                   # the gateway's max_peaks
#: The north star's lattice precision (bench.py --precision): f32
#: operands.  TF32 ('default') lost SF12 singles on the H100 (PERF.md).
GATEWAY_PRECISION = "highest"

#: Height tolerance, relative to each hop's largest reference height, and
#: the band inside which a reference decision counts as a near-tie.
#: highest: f32 operands through up to three chained stages (four-step
#:   DFT, overlap j-sum, window taps); a few f32 ulps (~6e-8) each.
#: default: TF32 operands on the tensor cores, 10 explicit mantissa bits,
#:   unit roundoff 2^-11 ~ 4.9e-4; four of it.
#: bf16: 7 explicit mantissa bits, unit roundoff 2^-8 ~ 3.9e-3; four of it.
TOLERANCE = {"highest": 1e-5, "default": 2e-3, "bf16": 1.6e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(count: int):
    """Phase 1.  Returns the first device; refuses anything but GPUs."""
    import jax

    from gr_lora_tpu import native
    from gr_lora_tpu.runtime import enable_compile_cache, require_gpu

    dev = require_gpu("chip_smoke.py")
    devices = jax.devices()
    if len(devices) < count:
        raise SystemExit(f"needs {count} GPUs, JAX has {len(devices)}")
    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f"card: {line.strip()}")
    log(f"jax {jax.__version__}: {devices} device_kind={dev.device_kind}")
    log(f"compile cache: {cache}")
    have_native = native.available()
    log(f"native tracker available: {have_native}")
    if not have_native:
        raise SystemExit("native library did not build (make -C native); "
                         "the gateway would fall back to the Python tracker")
    return dev


def phase_lattice(backend: str, precisions=("highest", "default"),
                  sfs=SFS, hops: int = LATTICE_HOPS) -> None:
    """Phase 2: peak_lattice_fn on the device vs the float64 reference."""
    import jax

    from gr_lora_tpu import LoraConfig
    from gr_lora_tpu.fixtures import tone_fixture
    from gr_lora_tpu.models.pyramid import (lattice_formulation,
                                            peak_lattice_fn)
    from gr_lora_tpu.models.pyramid_ref import (compare_lattice,
                                                reference_spectra)
    from gr_lora_tpu.ops.cplx import to_ri

    failed = []
    for sf in sfs:
        for prec in precisions:
            tol = TOLERANCE[prec]
            cfg = LoraConfig(sf=sf, p=2, fft_factor=8, threshold=5.0,
                             precision=prec)
            iq = tone_fixture(cfg, hops, seed=sf)
            got = jax.device_get(jax.jit(
                peak_lattice_fn(cfg, hops, MAX_PEAKS, backend))(to_ri(iq)))
            r = compare_lattice(reference_spectra(iq, cfg, hops), got, cfg,
                                MAX_PEAKS, tol)
            ok = (not r["mismatch"] and r["h_err"] <= tol
                  and r["h_single_err"] <= tol)
            log(f"lattice sf={sf} {backend}"
                f"({lattice_formulation(cfg, backend)}) precision={prec} "
                f"hops={hops} peaks={r['peaks']} tol={tol:g} "
                f"h_err={r['h_err']:.3g} h_single_err="
                f"{r['h_single_err']:.3g} near_ties={len(r['near_tie'])} "
                f"mismatches={len(r['mismatch'])} "
                f"{'ok' if ok else 'FAIL'}")
            for t, b, why in r["near_tie"]:
                log(f"  near-tie hop={t} bin={b}: {why}")
            for t, b, why in r["mismatch"]:
                log(f"  MISMATCH hop={t} bin={b}: {why}")
            if not ok:
                failed.append((sf, prec))
    if failed:
        raise AssertionError(f"lattice disagrees with the reference: "
                             f"{failed}")


def run_north_star(channels: int = CHANNELS, T: int = AIR, sfs=SFS,
                   mesh=None, memory: bool = False):
    """warmup, one feed of the fixture, flush.  Returns (expected PDUs,
    delivered PDU counts)."""
    import jax
    import jax.numpy as jnp

    from gr_lora_tpu import LoraConfig
    from gr_lora_tpu.dist.collision_gateway import TriggeredPyramidGateway
    from gr_lora_tpu.fixtures import north_star_fixture, pdu_counts
    from gr_lora_tpu.ops.cplx import to_ri

    base = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                      payload_len=8, p=2, fft_factor=8, threshold=5.0,
                      precision=GATEWAY_PRECISION)
    gw = TriggeredPyramidGateway(base, channels, sfs=sfs,
                                 max_payload_len=16, event_batch=8,
                                 scan_precision="bf16", mesh=mesh)
    iq, expected = north_star_fixture(
        {sf: st.cfg for sf, st in gw.sf_states.items()}, channels, T)
    ri = to_ri(iq) if mesh is not None else jax.device_put(to_ri(iq))
    t0 = time.perf_counter()
    gw.warmup()
    t1 = time.perf_counter()
    got = gw.feed(ri) + gw.flush()
    t2 = time.perf_counter()
    log(f"north star ({'mesh ' + str(dict(mesh.shape)) if mesh else '1 device'}"
        f", {channels} ch x SF{min(sfs)}-{max(sfs)}, T={T}, backend="
        f"{gw.backend}): smoke timing, one run: warmup {t1 - t0:.1f} s, "
        f"feed+flush {t2 - t1:.2f} s")
    log(f"  wall split: {json.dumps({k: round(v, 4) for k, v in gw.wall.items()})}"
        f" lattice_split: "
        f"{json.dumps({k: round(v, 4) for k, v in gw.lattice_split.items()})}"
        f" stats: {json.dumps(gw.stats())}")
    if memory:
        st = gw.sf_states[max(sfs)]
        prog = gw._lattice(st).lower(jax.ShapeDtypeStruct(
            (gw.event_batch, gw._win_samples(st), 2), jnp.float32)).compile()
        log(f"  SF{max(sfs)} window program memory_analysis "
            f"(lanes={gw.event_batch}, win_hops={st.win_hops}, "
            f"block_hops={gw._lattice_block_hops(st)}): "
            f"{prog.memory_analysis()}")
    return expected, pdu_counts(got)


def require_exact(what: str, expected: set, got) -> None:
    from gr_lora_tpu.fixtures import check_pdus

    c = check_pdus(expected, got)
    log(f"{what}: expected={len(expected)} delivered={sum(got.values())} "
        f"missing={len(c['missing'])} extra={len(c['extra'])} "
        f"duplicated={len(c['duplicated'])}")
    for k in ("missing", "extra", "duplicated"):
        for item in c[k][:16]:
            log(f"  {k}: {item}")
    if c["missing"] or c["extra"] or c["duplicated"]:
        raise AssertionError(f"{what}: PDUs not delivered exactly once")


def phase_north_star(channels: int = CHANNELS, T: int = AIR, sfs=SFS):
    """Phase 3."""
    expected, got = run_north_star(channels, T, sfs, memory=True)
    require_exact("north star PDUs", expected, got)


def phase_cli(out: Path, sfs: str | None = None, seed: int = 0):
    """Phase 4: the product command on a seeded 8-channel 1 Msps capture
    (the CLI's own defaults), PDUs collected over localhost UDP."""
    from gr_lora_tpu.apps import gateway
    from gr_lora_tpu.apps.common import UdpPduPort
    from gr_lora_tpu.fixtures import wideband_capture

    channels, fs = 8, 1e6
    wide, expected = wideband_capture(channels, fs, first=2, seed=seed)
    out.mkdir(parents=True, exist_ok=True)
    cap = out / "wideband.cf64"
    wide.astype(np.complex64).tofile(cap)
    port = UdpPduPort(listen_port=0)
    try:
        argv = [str(cap), "--collision", "--quiet", "--udp",
                f"127.0.0.1:{port.sock.getsockname()[1]}"]
        if sfs is not None:
            argv += ["--sfs", sfs]
        t0 = time.perf_counter()
        rc = gateway.main(argv)
        log(f"cli: apps.gateway {' '.join(argv[1:])} -> rc={rc}; smoke "
            f"timing, one run, compiles included: "
            f"{time.perf_counter() - t0:.1f} s for {len(wide) / fs:.3f} s "
            f"of {channels}-channel air")
        # Wire format: 1B channel, 1B sf, 4B LE position, payload.
        got = Counter()
        port.sock.settimeout(0.5)
        try:
            while True:
                d = port.sock.recvfrom(65536)[0]
                got[(d[0], d[1], d[6:].hex())] += 1
        except socket.timeout:
            pass
    finally:
        port.close()
    if rc != 0:
        raise AssertionError(f"apps.gateway exited {rc}")
    require_exact("cli PDUs", expected, got)


def phase_four(channels: int = CHANNELS, T: int = AIR, sfs=SFS) -> None:
    """The two mesh gateways, each against its one-device run."""
    import jax
    from jax.sharding import Mesh

    from __graft_entry__ import _dryrun_pyramid_gateway
    from gr_lora_tpu.dist.gateway import make_mesh

    devs = jax.devices()[:4]
    expected, one = run_north_star(channels, T, sfs)
    _, four = run_north_star(channels, T, sfs,
                             mesh=Mesh(np.asarray(devs), ("ch",)))
    require_exact("north star PDUs, 1 device", expected, one)
    require_exact("north star PDUs, ('ch',) mesh of 4", expected, four)
    if one != four:
        raise AssertionError("4-device north star differs from 1 device")
    t0 = time.perf_counter()
    single = _dryrun_pyramid_gateway(None, 2)
    t1 = time.perf_counter()
    meshed = _dryrun_pyramid_gateway(make_mesh(2, 2, devices=devs), 2)
    t2 = time.perf_counter()
    log(f"{{ch: 2, t: 2}} collision gateway: 1 device {len(single)} PDUs "
        f"({t1 - t0:.1f} s), mesh {len(meshed)} PDUs ({t2 - t1:.1f} s); "
        f"smoke timing, one run, compiles included")
    if single != meshed:
        raise AssertionError(f"{{ch, t}} mesh PDUs {sorted(meshed)} differ "
                             f"from one device's {sorted(single)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU mesh gateways against their "
                         "one-GPU runs")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/smoke"),
                    help="where the CLI phase writes its capture")
    args = ap.parse_args(argv)

    import jax

    from gr_lora_tpu.dist.collision_gateway import DEFAULT_BACKEND

    count = 4 if args.four else 1
    dev = phase_device(count)
    if args.four:
        phase_four()
    else:
        phase_lattice(DEFAULT_BACKEND)
        phase_north_star()
        phase_cli(args.out)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
