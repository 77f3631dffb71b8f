"""End-to-end wideband gateway chain (VERDICT r1 #9, r2 #4).

ONE fixture through the FULL product path the README advertises — both as
a hand-assembled chain (channelizer -> triggered receiver + pyramid
gateway -> PduSink) and as ONE `apps.gateway --collision` CLI command
(capture -> streaming channelizer -> detection-gated pyramid -> UDP).
Every injected payload must arrive exactly once with the right channel /
SF / position.
"""

import socket

import numpy as np
import pytest

from gr_lora_tpu.apps.common import UdpPduPort
from gr_lora_tpu.dist.pdu_sink import PduEvent, PduSink
from gr_lora_tpu.dist.pyramid_gateway import PyramidGateway
from gr_lora_tpu.dist.triggered import TriggeredReceiver
from gr_lora_tpu.fixtures import (GOLDEN_PDUS, WIDEBAND_COLLISION_CFG,
                                  WIDEBAND_COLLISION_CH,
                                  WIDEBAND_SINGLE_BASE, WIDEBAND_SINGLES,
                                  wideband_capture)
from gr_lora_tpu.pipeline.channelizer import channelize

FS = 500e3
SPACING = 125e3
CHANNELS = 4
P = 2

PYR_CFG = WIDEBAND_COLLISION_CFG
TRIG_BASE = WIDEBAND_SINGLE_BASE

# channel: (sf, payload bytes, baseband offset in samples); layout notes
# in gr_lora_tpu.fixtures.
PAYLOADS = WIDEBAND_SINGLES
COLL_CH = WIDEBAND_COLLISION_CH
PDU_1, PDU_2 = GOLDEN_PDUS


def _wideband_fixture(seed=0):
    """Per-channel packets synthesized directly AT the wideband rate
    (modulate supports any p — no upsampling images), mixed to their
    channel slots and summed."""
    return wideband_capture(CHANNELS, FS, SPACING, seed=seed)[0]


def test_wideband_chain_to_udp():
    import jax

    wide = _wideband_fixture()
    wide_ri = np.stack([wide.real, wide.imag], -1).astype(np.float32)
    chans = np.ascontiguousarray(np.asarray(jax.device_get(
        channelize(wide_ri, CHANNELS, FS, SPACING, p=P))))
    assert chans.shape[0] == CHANNELS

    rx_port = UdpPduPort(listen_port=0)
    addr = rx_port.sock.getsockname()
    sink = PduSink(udp=("127.0.0.1", addr[1]), crc_filter=True)

    # Triggered multi-SF receiver for the single packets (skip SF8: the
    # collision channel belongs to the pyramid path).
    trig = TriggeredReceiver(TRIG_BASE, sfs=(7, 9), bw=SPACING)
    for p in trig(chans):
        if p.result.crc_ok:
            sink.emit(PduEvent(p.channel, p.sf, p.position,
                               bytes(p.result.payload), p.result.crc_ok))

    # Pyramid collision gateway over all channels at SF8.
    gw = PyramidGateway(PYR_CFG, CHANNELS, block_hops=512)
    for pkt in gw.feed(chans) + gw.flush():
        if pkt.result is not None and pkt.result.ok and pkt.result.crc_ok:
            sink.emit(PduEvent(pkt.channel, 8, pkt.position,
                               bytes(pkt.result.payload), pkt.result.crc_ok))

    # Collect UDP datagrams (wire format: ch, sf, pos_le32, payload).
    got = []
    rx_port.sock.settimeout(0.5)
    try:
        while True:
            data, _ = rx_port.sock.recvfrom(65536)
            got.append((data[0], data[1],
                        int.from_bytes(data[2:6], "little", signed=False),
                        data[6:].hex()))
    except socket.timeout:
        pass
    finally:
        rx_port.close()
        sink.close()

    # A LoRa signal fills its whole channel, so a strong packet's spectral
    # skirt can decode on neighboring channels too; dedupe by RSSI exactly
    # like apps/gateway.py (production-gateway behavior).
    def rssi(ch, sf, pos):
        n = (1 << sf) * P
        seg = chans[ch, pos:pos + 8 * n]
        return float(np.mean(seg ** 2)) if seg.size else 0.0

    best = {}
    for ch, sf, pos, pdu in got:
        key = (sf, pdu)
        if key not in best or rssi(ch, sf, pos) > rssi(*best[key][:3]):
            best[key] = (ch, sf, pos, pdu)
    deduped = list(best.values())

    def hits(pred):
        return [g for g in deduped if pred(g)]

    # Singles: exactly once, right channel/SF, position near injection
    # (PDU = 3 header bytes + payload + CRC + pass flag).
    for ch, (sf, payload, off) in PAYLOADS.items():
        n = (1 << sf) * P
        matches = hits(lambda g, ch=ch, sf=sf, payload=payload:
                       g[0] == ch and g[1] == sf
                       and g[3][6:].startswith(payload.hex()))
        assert len(matches) == 1, (ch, sf, matches, deduped)
        pos = matches[0][2]
        assert 0 <= pos - off <= 10 * n, (pos, off)

    # Collision pair: both golden PDUs exactly once on the collision
    # channel, positions near the injected preamble starts.
    n8 = PYR_CFG.num_samples
    m1 = hits(lambda g: g[0] == COLL_CH and g[3] == PDU_1)
    m2 = hits(lambda g: g[0] == COLL_CH and g[3] == PDU_2)
    assert len(m1) == 1, (m1, deduped)
    assert len(m2) == 1, (m2, deduped)
    # Pyramid positions are the tracker's preamble REFERENCE timestamp
    # (the walked-back apex of the last trackable preamble chirp, ~7
    # symbols after packet start).
    off2 = 1000 + 16 * n8 + 4 * n8 // 8 + 204
    assert 0 <= m1[0][2] - 1000 <= 10 * n8, m1
    assert 0 <= m2[0][2] - off2 <= 10 * n8, m2

    # Nothing survives on the idle channel.
    assert not hits(lambda g: g[0] == 3), deduped


def test_wideband_cli_collision_to_udp(tmp_path):
    """The SAME fixture through the ONE product command (VERDICT r2 #4):
    `apps.gateway CAPTURE --collision --udp ...` reproduces the README
    collision PDUs plus the single packets, each exactly once, over UDP."""
    from gr_lora_tpu.apps import gateway

    wide = _wideband_fixture()
    cap = tmp_path / "wideband.cf64"
    wide.astype(np.complex64).tofile(cap)

    rx_port = UdpPduPort(listen_port=0)
    addr = rx_port.sock.getsockname()

    rc = gateway.main([
        str(cap), "--collision", "--quiet",
        "--udp", f"127.0.0.1:{addr[1]}",
        "--samp-rate", str(FS), "--channels", str(CHANNELS),
        "--spacing", str(SPACING), "--sfs", "7,8,9",
        "--payload-len", "8", "--fft-factor", "8",
        "--max-payload-len", "16",
    ])
    assert rc == 0

    got = []
    rx_port.sock.settimeout(0.5)
    try:
        while True:
            data, _ = rx_port.sock.recvfrom(65536)
            got.append((data[0], data[1],
                        int.from_bytes(data[2:6], "little", signed=False),
                        data[6:].hex()))
    except socket.timeout:
        pass
    finally:
        rx_port.close()

    def hits(pred):
        return [g for g in got if pred(g)]

    # Singles: exactly once, right channel/SF.
    for ch, (sf, payload, off) in PAYLOADS.items():
        n = (1 << sf) * P
        matches = hits(lambda g, ch=ch, sf=sf, payload=payload:
                       g[0] == ch and g[1] == sf
                       and g[3][6:].startswith(payload.hex()))
        assert len(matches) == 1, (ch, sf, matches, got)
        assert 0 <= matches[0][2] - off <= 10 * n, (matches[0][2], off)

    # Collision pair: both golden PDUs exactly once on the collision
    # channel (positions are the pyramid preamble reference timestamps).
    n8 = PYR_CFG.num_samples
    off2 = 1000 + 16 * n8 + 4 * n8 // 8 + 204
    m1 = hits(lambda g: g[0] == COLL_CH and g[3] == PDU_1)
    m2 = hits(lambda g: g[0] == COLL_CH and g[3] == PDU_2)
    assert len(m1) == 1, (m1, got)
    assert len(m2) == 1, (m2, got)
    assert 0 <= m1[0][2] - 1000 <= 10 * n8, m1
    assert 0 <= m2[0][2] - off2 <= 10 * n8, m2
    assert not hits(lambda g: g[0] == 3), got
