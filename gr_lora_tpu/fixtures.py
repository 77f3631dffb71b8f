"""Seeded traffic fixtures with known PDUs, shared by ``bench.py``,
``chip_smoke.py`` and the tests.

Every fixture returns its IQ together with the PDUs that must come out of
it, each as ``(channel, sf, pdu_hex)``: the decoded payload bytes as the
codec emits them (explicit header + payload + CRC + pass flag).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from .config import LoraConfig
from .core.codec import decode, encode
from .models.modulator import modulate
from .ops.chirp import symbol_chirp

#: The README's two-packet collision (reference README.md scenario): a
#: strong SF8 packet and a weaker one starting 16.5 symbols + 204 samples
#: later.  Both PDUs are known byte-exact.
COLLISION_PAYLOADS = (bytes([1, 2, 3, 4, 5, 6]), bytes([7] * 5))
GOLDEN_PDUS = ("0630f0010203040506050801", "053000" + "07" * 5 + "e76b01")
COLLISION_AMPS = (0.2, 0.09)


def collision_offset(n: int) -> int:
    """Start of the weak packet relative to the strong one (n = samples
    per symbol)."""
    return 16 * n + 4 * n // 8 + 204


def expected_pdu(payload: bytes, cfg: LoraConfig) -> str:
    """The PDU hex a clean reception of ``payload`` decodes to."""
    return bytes(decode(encode(payload, cfg), cfg).payload).hex()


def north_star_single(sf: int) -> bytes:
    return bytes([sf, 1, 2, sf])


def north_star_fixture(cfgs: dict, channels: int, T: int, seed: int = 0,
                       noise: float = 0.003):
    """The north-star air window: on every channel the golden SF8
    collision, plus one single packet at a round-robin SF.

    ``cfgs`` maps SF -> the gateway's LoraConfig for it
    (``{sf: st.cfg for sf, st in gw.sf_states.items()}``).  Returns
    ``(iq complex64 [channels, T], expected)``; a single that does not fit
    the window (SF12 in a short one) is neither placed nor expected.
    """
    sfs = tuple(cfgs)
    cfg8 = cfgs.get(8, cfgs[sfs[0]])
    n8 = cfg8.num_samples
    p1, p2 = (a * modulate(encode(pl, cfg8), cfg8, pad_front=0, pad_back=0)
              for a, pl in zip(COLLISION_AMPS, COLLISION_PAYLOADS))
    singles = {sf: 0.15 * modulate(encode(north_star_single(sf), c), c,
                                   pad_front=0, pad_back=0)
               for sf, c in cfgs.items()}
    single_pdu = {sf: expected_pdu(north_star_single(sf), c)
                  for sf, c in cfgs.items()}
    rng = np.random.default_rng(seed)
    iq = (noise * (rng.standard_normal((channels, T))
                   + 1j * rng.standard_normal((channels, T)))
          ).astype(np.complex64)
    off2 = collision_offset(n8)
    expected = set()
    for c in range(channels):
        base = (4000 + c * 4999) % (T // 2)
        iq[c, base:base + len(p1)] += p1
        iq[c, base + off2:base + off2 + len(p2)] += p2
        expected |= {(c, cfg8.sf, pdu) for pdu in GOLDEN_PDUS}
        sf = sfs[c % len(sfs)]
        s = singles[sf]
        if len(s) + 1 < T - T * 2 // 3:
            so = T * 2 // 3 + (c * 2999) % (T - T * 2 // 3 - len(s) - 1)
            iq[c, so:so + len(s)] += s
            expected.add((c, sf, single_pdu[sf]))
    return iq, expected


def tone_fixture(cfg: LoraConfig, num_hops: int, seed: int = 0,
                 noise: float = 0.01) -> np.ndarray:
    """complex64 IQ spanning ``num_hops`` lattice hops: two upchirp
    trains at seeded symbol values, strong and weak, the weak one offset
    by a seeded sub-symbol delay, under white noise.  Dechirped, each is a
    known tone."""
    n = cfg.num_samples
    total = (num_hops - 1) * (n // 8) + n
    rng = np.random.default_rng(seed)
    s1, s2 = rng.integers(0, cfg.num_symbols, 2)
    delay = int(rng.integers(1, n))
    reps = -(-(total + delay) // n)
    strong = np.tile(symbol_chirp(int(s1), cfg.sf, cfg.p), reps)[:total]
    weak = np.tile(symbol_chirp(int(s2), cfg.sf, cfg.p),
                   reps)[delay:delay + total]
    iq = noise * (rng.standard_normal(total)
                  + 1j * rng.standard_normal(total))
    return (iq + 0.2 * strong + 0.09 * weak).astype(np.complex64)


#: Wideband capture layout: channel -> (sf, payload, baseband offset).
#: The encoded symbol streams have no adjacent-equal symbols (the Pyramid
#: lattice merges equal back-to-back apexes into one track), and the SF7
#: single sits after the adjacent-channel collision, whose spectral skirt
#: would otherwise perturb its apex bins (tests/test_wideband_e2e.py).
WIDEBAND_SINGLES = {0: (7, bytes([0x10, 0x20, 0x30, 0x40]), 26000),
                    2: (9, bytes([0xDE, 0xAD, 0xBE, 0xEF]), 5000)}
WIDEBAND_COLLISION_CH = 1
WIDEBAND_COLLISION_OFFSET = 1000
WIDEBAND_SINGLE_BASE = LoraConfig(sf=7, cr=1, crc=True, ldr=False,
                                  explicit_header=True, payload_len=8,
                                  p=2, fft_factor=4)
WIDEBAND_COLLISION_CFG = LoraConfig(sf=8, cr=1, crc=True, ldr=False,
                                    explicit_header=True, payload_len=8,
                                    p=2, fft_factor=8, threshold=5.0)


def wideband_capture(channels: int, fs: float, spacing: float = 125e3,
                     first: int = 0, seed: int = 0):
    """One wideband complex64 capture at ``fs`` carrying the
    WIDEBAND_SINGLES and the golden collision, shifted up by ``first``
    channels.  Packets are synthesized directly at the wideband rate and
    mixed to their channel centres (pipeline/channelizer
    .channel_frequencies).  Returns ``(wide, expected)``."""
    from .pipeline.channelizer import channel_frequencies

    p = WIDEBAND_COLLISION_CFG.p
    n8 = WIDEBAND_COLLISION_CFG.num_samples
    up = int(round(fs / (p * spacing)))
    if up * p * spacing != fs:
        raise ValueError(f"fs {fs} is not a multiple of p * spacing")
    pw = p * up
    total = (1000 + 76 * n8) * up
    freqs = channel_frequencies(channels, spacing)
    t = np.arange(total) / fs
    wide = np.zeros(total, np.complex64)

    def place(ch, iq_w, off_bb):
        off = off_bb * up
        wide[off:off + len(iq_w)] += (
            iq_w * np.exp(2j * np.pi * freqs[ch] * t[off:off + len(iq_w)])
        ).astype(np.complex64)

    expected = set()
    for ch, (sf, payload, off) in WIDEBAND_SINGLES.items():
        cfg = WIDEBAND_SINGLE_BASE.replace(
            sf=sf, ldr=(1 << sf) / spacing > 16e-3)
        place(first + ch, 0.4 * modulate(encode(payload, cfg), cfg, p=pw,
                                         pad_front=0, pad_back=0), off)
        expected.add((first + ch, sf, expected_pdu(payload, cfg)))
    cfg8 = WIDEBAND_COLLISION_CFG
    ch = first + WIDEBAND_COLLISION_CH
    for amp, pl, off in zip((0.4, 0.18), COLLISION_PAYLOADS,
                            (WIDEBAND_COLLISION_OFFSET,
                             WIDEBAND_COLLISION_OFFSET
                             + collision_offset(n8))):
        place(ch, amp * modulate(encode(pl, cfg8), cfg8, p=pw,
                                 pad_front=0, pad_back=0), off)
    expected |= {(ch, 8, pdu) for pdu in GOLDEN_PDUS}
    rng = np.random.default_rng(seed)
    wide += 0.01 * (rng.standard_normal(total)
                    + 1j * rng.standard_normal(total)).astype(np.complex64)
    return wide, expected


def pdu_counts(packets) -> Counter:
    """CRC-valid PDUs of gateway packets (anything with ``channel``,
    ``sf`` and a decode ``result``), counted per ``(channel, sf, hex)``."""
    return Counter((int(p.channel), int(p.sf), bytes(p.result.payload).hex())
                   for p in packets
                   if p.result is not None and p.result.ok
                   and p.result.crc_ok)


def check_pdus(expected: set, got: Counter) -> dict:
    """Compare delivered PDU counts with the expected set: what is
    missing, what came that was not sent, and what came more than once."""
    return {"missing": sorted(expected - set(got)),
            "extra": sorted(set(got) - expected),
            "duplicated": sorted(k for k, v in got.items() if v > 1)}
