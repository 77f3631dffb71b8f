"""Collision file receiver — examples/rx_file_collision.grc as a CLI.

    python -m gr_lora_tpu.apps.rx_file_collision capture.cf64 --samp-rate 1e6

Pyramid collision decoding: prints one hex PDU per recovered packet
(the reference README.md:26-42 scenario).
"""

from __future__ import annotations

import argparse
import sys

from ..runtime import enable_compile_cache
from .common import add_config_args, config_from_args, print_pdu, read_capture


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("capture", help="raw complex64 IQ file")
    ap.add_argument("--samp-rate", type=float, default=1e6)
    add_config_args(ap)
    args = ap.parse_args(argv)
    enable_compile_cache()
    cfg = config_from_args(args)

    from ..pipeline.frontend import replay

    iq = read_capture(args.capture)
    results = replay(iq, args.samp_rate, cfg, bw=args.bw, mode="pyramid")
    for _, res in results:
        if res.ok:
            print_pdu(bytes(res.payload))
        else:
            print("broken packet (decode failed)", file=sys.stderr)
    return 0 if any(r.ok for _, r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
