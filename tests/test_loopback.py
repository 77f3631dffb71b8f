"""Full-PHY loopback: encode -> modulate -> demod FSM -> decode, byte-exact.

The JAX analog of the reference's txrx_sim.grc self-test (SURVEY.md section 4.2).
"""

import numpy as np
import pytest

from gr_lora_tpu import LoraConfig
from gr_lora_tpu.models.transceiver import loopback


def _check(cfg, payload, **kw):
    r = loopback(payload, cfg, **kw)
    assert len(r.packets) == 1, f"expected 1 packet, got {len(r.packets)}"
    d = r.decoded[0]
    assert d.ok, d.reason
    off = 3 if cfg.explicit_header else 0
    assert bytes(d.payload[off:off + len(payload)]) == payload
    if cfg.crc:
        assert d.crc_ok
    return r


def test_loopback_readme_config_explicit():
    cfg = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                     p=2, fft_factor=2)
    r = _check(cfg, bytes([1, 2, 3, 4, 5, 6]))
    assert bytes(r.decoded[0].payload).hex() == "0630f0010203040506050801"


def test_loopback_txrx_sim_config_implicit_ldr():
    # txrx_sim.grc: SF8, CR4, implicit header, LDR on (SURVEY.md 3.1/3.2).
    cfg = LoraConfig(sf=8, cr=4, crc=True, ldr=True, explicit_header=False,
                     payload_len=8, p=2, fft_factor=2)
    _check(cfg, bytes(range(8)))


@pytest.mark.parametrize("sf", [7, 9, 10, 12])
def test_loopback_sf_sweep(sf):
    cfg = LoraConfig(sf=sf, cr=2, crc=True, ldr=(sf >= 11),
                     explicit_header=False, payload_len=12, p=2, fft_factor=2)
    _check(cfg, bytes((3 * i + 1) % 256 for i in range(12)))


def test_loopback_p4():
    cfg = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                     p=4, fft_factor=2)
    _check(cfg, bytes([0xDE, 0xAD, 0xBE, 0xEF]))


def test_loopback_with_awgn():
    cfg = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                     p=2, fft_factor=2)
    _check(cfg, bytes([1, 2, 3, 4, 5, 6]), snr_db=10.0)


def test_loopback_back_to_back_packets():
    """Two packets in one stream must both demodulate (FSM re-arms)."""
    from gr_lora_tpu.core.codec import decode, encode
    from gr_lora_tpu.models.demodulator import demodulate
    from gr_lora_tpu.models.modulator import modulate

    cfg = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                     p=2, fft_factor=2)
    p1, p2 = bytes([1, 2, 3]), bytes([9, 8, 7, 6])
    iq = np.concatenate([modulate(encode(p1, cfg), cfg),
                         modulate(encode(p2, cfg), cfg)])
    pkts = demodulate(iq, cfg)
    assert len(pkts) == 2
    d1, d2 = decode(pkts[0], cfg), decode(pkts[1], cfg)
    assert d1.ok and bytes(d1.payload[3:6]) == p1
    assert d2.ok and bytes(d2.payload[3:7]) == p2


def test_loopback_cfo_tolerance():
    """A fractional-bin carrier offset must be absorbed by the preamble CFO
    estimate (reference: demod_impl.cc:485-491)."""
    from gr_lora_tpu.core.codec import decode, encode
    from gr_lora_tpu.models.demodulator import demodulate
    from gr_lora_tpu.models.modulator import modulate

    cfg = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                     p=2, fft_factor=2)
    payload = bytes([5, 4, 3, 2, 1])
    iq = modulate(encode(payload, cfg), cfg)
    # CFO of 0.3 bins = 0.3 * bw / 2^sf Hz.
    f_rel = 0.3 / (cfg.p * cfg.num_symbols)
    iq = (iq * np.exp(2j * np.pi * f_rel * np.arange(len(iq)))).astype(np.complex64)
    pkts = demodulate(iq, cfg)
    assert len(pkts) == 1
    d = decode(pkts[0], cfg)
    assert d.ok and d.crc_ok and bytes(d.payload[3:8]) == payload


def test_back_to_back_packets_minimal_gap():
    """Two packets separated by only the FSM's reset/prefill budget are both
    decoded (stream recycling, reference S_OUT -> S_RESET path)."""
    import numpy as np

    from gr_lora_tpu.core.codec import decode, encode
    from gr_lora_tpu.models.demodulator import demodulate
    from gr_lora_tpu.models.modulator import modulate
    from gr_lora_tpu.ops.cplx import to_ri

    cfg = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                     payload_len=4, p=2, fft_factor=8)
    n = cfg.num_samples
    pkt = to_ri(modulate(encode(bytes([5, 6, 7, 8]), cfg), cfg,
                         pad_front=0, pad_back=0))
    gap = 8 * n                      # reset(1) + prefill(4) + margin
    iq = np.concatenate([
        np.zeros((2 * n, 2), np.float32), pkt,
        np.zeros((gap, 2), np.float32), pkt,
        np.zeros((6 * n, 2), np.float32),
    ])
    pkts = demodulate(iq, cfg)
    ok = [decode(s, cfg) for s in pkts]
    assert sum(1 for r in ok if r.ok and bytes(r.payload[3:7]) == bytes([5, 6, 7, 8])) == 2


def test_packet_at_stream_start():
    """A packet whose preamble begins at sample 0 still decodes (the
    demodulator's own history prefill supplies the lead-in)."""
    import numpy as np

    from gr_lora_tpu.core.codec import decode, encode
    from gr_lora_tpu.models.demodulator import demodulate
    from gr_lora_tpu.models.modulator import modulate
    from gr_lora_tpu.ops.cplx import to_ri

    cfg = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                     payload_len=4, p=2, fft_factor=8)
    iq = to_ri(modulate(encode(bytes([1, 1, 2, 2]), cfg), cfg,
                        pad_front=0))
    pkts = demodulate(iq, cfg)
    assert any(decode(s, cfg).ok and bytes(decode(s, cfg).payload[3:7])
               == bytes([1, 1, 2, 2]) for s in pkts)
