"""TX->RX loopback simulator — examples/txrx_sim.grc as a CLI.

    # one-shot payloads on the command line:
    python -m gr_lora_tpu.apps.txrx_sim --payload 0102030405 --snr 10

    # UDP PDU service (socket_pdu equivalent, reference ports 52001/52002):
    python -m gr_lora_tpu.apps.txrx_sim --udp --count 3

Each payload goes through encode -> modulate -> (AWGN) -> demod FSM ->
decode; the decoded PDU is printed (and sent to the UDP out port in --udp
mode).  The reference default config is SF8 / 250 ksps / CR 4/8 / implicit
header / LDR on (txrx_sim.grc variables).
"""

from __future__ import annotations

import argparse

from ..runtime import enable_compile_cache
from .common import (
    DEFAULT_UDP_IN,
    DEFAULT_UDP_OUT,
    UdpPduPort,
    add_config_args,
    config_from_args,
    print_pdu,
)


def run_once(payload: bytes, cfg, snr_db):
    from ..models.transceiver import loopback

    r = loopback(payload, cfg, snr_db=snr_db)
    return [bytes(d.payload) for d in r.decoded if d.ok]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--payload", action="append", default=None,
                    help="hex payload (repeatable); omit with --udp")
    ap.add_argument("--snr", type=float, default=None, help="AWGN SNR in dB")
    ap.add_argument("--udp", action="store_true",
                    help="serve payloads from UDP instead of the CLI")
    ap.add_argument("--udp-in", type=int, default=DEFAULT_UDP_IN)
    ap.add_argument("--udp-out", type=int, default=DEFAULT_UDP_OUT)
    ap.add_argument("--count", type=int, default=0,
                    help="UDP mode: exit after N datagrams (0 = forever)")
    # txrx_sim.grc defaults: implicit header, CR 4/8, LDR on.
    ap.set_defaults()
    add_config_args(ap)
    ap.set_defaults(cr=4, implicit_header=True, ldr="on", fft_factor=10,
                    payload_len=5)
    args = ap.parse_args(argv)
    enable_compile_cache()
    cfg = config_from_args(args)

    ok_any = False
    if args.udp:
        port = UdpPduPort(listen_port=args.udp_in,
                          send_addr=("127.0.0.1", args.udp_out))
        served = 0
        while args.count == 0 or served < args.count:
            data = port.recv(timeout=30.0)
            if data is None:
                break
            cfg_i = cfg if cfg.explicit_header else cfg.replace(
                payload_len=len(data))
            for pdu in run_once(data, cfg_i, args.snr):
                print_pdu(pdu)
                port.send(pdu)
                ok_any = True
            served += 1
        port.close()
    else:
        for h in (args.payload or []):
            payload = bytes.fromhex(h)
            cfg_i = cfg if cfg.explicit_header else cfg.replace(
                payload_len=len(payload))
            for pdu in run_once(payload, cfg_i, args.snr):
                print_pdu(pdu)
                ok_any = True
    return 0 if ok_any else 1


if __name__ == "__main__":
    raise SystemExit(main())
