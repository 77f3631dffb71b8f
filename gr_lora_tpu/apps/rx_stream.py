"""Streaming receiver: demodulate an unbounded IQ stream incrementally.

    # from a growing capture file or a fifo:
    python -m gr_lora_tpu.apps.rx_stream capture.cf64 --samp-rate 250e3

    # from stdin (e.g. an SDR tool piping complex64):
    some_sdr_rx | python -m gr_lora_tpu.apps.rx_stream - --samp-rate 250e3

    # from a UDP IQ feed (SDR-agnostic live source; the rx_usrp.grc analog
    # for hardware this environment lacks — any SDR tool that emits
    # complex64 datagrams can feed it):
    python -m gr_lora_tpu.apps.rx_stream udp:5005 --samp-rate 250e3

Unlike rx_file (whole-capture replay), this uses the carried-state
streaming FSM (StreamingDemodulator): packets are reported as soon as they
complete, chunk boundaries are invisible, and memory stays O(block).  Input
must already be at the demod rate fs = p * bw (use rx_file for raw captures
needing the LPF/resampler front-end).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..runtime import enable_compile_cache
from .common import add_config_args, config_from_args, print_pdu


class UdpIqSource:
    """File-like reader over UDP datagrams of raw complex64 IQ — the live
    SDR ingress (reference analog: uhd_usrp_source in rx_usrp.grc; any SDR
    tool that forwards IQ datagrams can feed this)."""

    def __init__(self, port: int, idle_timeout: float = 5.0):
        import socket

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
        self._sock.bind(("0.0.0.0", port))
        self._sock.settimeout(idle_timeout)
        self._buf = bytearray()

    def read(self, n: int) -> bytes:
        import socket

        while len(self._buf) < n:
            try:
                data, _ = self._sock.recvfrom(65536)
            except socket.timeout:
                break                      # idle: EOF-like drain
            if not data:
                break
            self._buf += data
            if len(self._buf) >= n:
                break
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def close(self) -> None:
        self._sock.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("source",
                    help="raw complex64 stream: path, '-' for stdin, or "
                         "'udp:PORT' for a datagram IQ feed")
    ap.add_argument("--idle-timeout", type=float, default=5.0,
                    help="udp source: stop after this many idle seconds")
    ap.add_argument("--samp-rate", type=float, default=250e3,
                    help="stream rate; must equal p*bw")
    ap.add_argument("--chunk", type=int, default=1 << 16,
                    help="samples per read")
    ap.add_argument("--no-ring", action="store_true",
                    help="disable the threaded native ring-buffer ingest "
                         "(synchronous reads instead)")
    add_config_args(ap)
    args = ap.parse_args(argv)
    enable_compile_cache()
    cfg = config_from_args(args)
    if abs(args.samp_rate - cfg.p * args.bw) > 1e-6:
        print(f"warning: samp_rate {args.samp_rate} != p*bw "
              f"{cfg.p * args.bw}; resample first (see rx_file)",
              file=sys.stderr)

    from ..core.codec import decode
    from ..models.demodulator import StreamingDemodulator

    if args.source == "-":
        stream = sys.stdin.buffer
    elif args.source.startswith("udp:"):
        stream = UdpIqSource(int(args.source[4:]), args.idle_timeout)
    else:
        stream = open(args.source, "rb")

    from .. import native
    if not args.no_ring and native.available():
        # Product path: producer thread -> lock-free ring -> pipelined
        # device blocks (pipeline/ingest.py).
        from ..pipeline.ingest import stream_demodulate

        found = 0

        def on_packet(pos, syms):
            nonlocal found
            res = decode(syms, cfg)
            if res.ok:
                print_pdu(bytes(res.payload), prefix=f"pdu @{pos}")
                found += 1

        try:
            stream_demodulate(cfg, stream, on_packet)
        finally:
            if stream is not sys.stdin.buffer:
                stream.close()
        return 0 if found else 1

    sd = StreamingDemodulator(cfg)
    found = 0
    try:
        while True:
            raw = stream.read(args.chunk * 8)   # complex64 = 8 bytes
            if not raw:
                break
            usable = len(raw) - (len(raw) % 8)
            if not usable:
                break
            iq = np.frombuffer(raw[:usable], np.complex64)
            for pos, syms in sd.feed(iq):
                res = decode(syms, cfg)
                if res.ok:
                    print_pdu(bytes(res.payload), prefix=f"pdu @{pos}")
                    found += 1
        for pos, syms in sd.flush():
            res = decode(syms, cfg)
            if res.ok:
                print_pdu(bytes(res.payload), prefix=f"pdu @{pos}")
                found += 1
    finally:
        if stream is not sys.stdin.buffer:
            stream.close()
    return 0 if found else 1


if __name__ == "__main__":
    raise SystemExit(main())
