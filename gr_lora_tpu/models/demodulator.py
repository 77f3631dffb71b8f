"""Single-packet demodulator: IQ stream -> symbol vectors.

A faithful re-expression of the reference 7-state FSM
(demod_impl.cc:293-628) as one jit-compiled ``lax.while_loop`` over a sample
pointer.  Every per-iteration FFT/argmax is a zoom-DFT matmul (ops/dft.py); all
state is a fixed-shape pytree, so the whole demodulator — including the
explicit-header feedback, which the reference routes through an async
message-port round-trip (demod_impl.cc:508-554 + decode_impl.cc:345-355) —
compiles to a single XLA program and can be vmapped over channels.

States: 0 RESET, 1 PREFILL, 2 DETECT_PREAMBLE, 3 SFD_SYNC, 4 READ_HEADER,
5 READ_PAYLOAD, 6 OUT (reference enum: include/lora/demod.h:41-49).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    DEMOD_SYNC_RECOVERY_COUNT,
    REQUIRED_PREAMBLE_CHIRPS,
    LoraConfig,
)
from ..core.header import calc_sym_num
from ..ops.cplx import to_ri
from ..ops.dechirp import down_peak, up_peak, up_peak_stats

_RESET, _PREFILL, _DETECT, _SFD, _HEADER, _PAYLOAD, _OUT = range(7)


def _fpmod(x, n):
    """Python-style float modulo (reference: utilities.h:48-51)."""
    return jnp.mod(jnp.mod(x, n) + n, n)


def _pmod(x, n):
    return jnp.mod(jnp.mod(x, n) + n, n)


def _popcount8(x):
    """Popcount of a uint8-ranged int32."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def _header_checksum_jnp(length, cr_crc):
    """5-bit header checksum, scalar bit ops (reference: utilities.h:96-120)."""
    a = [(length >> (4 + k)) & 1 for k in range(4)]
    b = [(length >> k) & 1 for k in range(4)]
    c = [(cr_crc >> k) & 1 for k in range(4)]
    res = (a[0] ^ a[1] ^ a[2] ^ a[3]) << 4
    res |= (a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3
    res |= (a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2
    res |= (a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1
    res |= a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3]
    return res


def _dynamic_compensation(symbols, count, cfg: LoraConfig):
    """LDR bin-drift integrator (reference: demod_impl.cc:263-284).

    symbols: float32[MS]; only the first ``count`` entries are live.
    Returns uint16[MS] compensated symbols (entries past count are zero).
    """
    nsym = float(cfg.num_symbols)
    modulus = 4.0

    def step(carry, xs):
        v_last, comp = carry
        v, i = xs
        drift = _fpmod(v - v_last, modulus)
        comp_new = comp - jnp.where(drift < modulus / 2, drift, drift - modulus)
        if not cfg.ldr:
            comp_new = jnp.float32(0.0)  # reference zeroes it when !ldr (:280)
        valid = i < count
        comp2 = jnp.where(valid, comp_new, comp)
        v_last2 = jnp.where(valid, v, v_last)
        out = _pmod(jnp.floor(_fpmod(v + comp2, nsym) + 0.5), nsym)
        return (v_last2, comp2), out

    ms = symbols.shape[0]
    (_, _), outs = jax.lax.scan(
        step, (jnp.float32(1.0), jnp.float32(0.0)),
        (symbols, jnp.arange(ms, dtype=jnp.int32)))
    outs = jnp.where(jnp.arange(ms) < count, outs, 0)
    return outs.astype(jnp.uint16)


def _parse_header_jnp(comp8, cfg: LoraConfig):
    """In-jit explicit-header parse of the 8 compensated header symbols.

    Mirrors decode_impl.cc:299-355 (normalize /4, Gray, deinterleave at
    ppm=sf-2/rdd=4, Hamming-correct, checksum).  Returns
    (is_valid, payload_len, cr, crc, packet_symbol_len).
    """
    sf = cfg.sf
    ppm = sf - 2
    v = (comp8 // 4).astype(jnp.int32)
    g = v ^ (v >> 1)
    # Deinterleave: cw[y] bit i = bit ((y - i) mod ppm) of g[i].
    y = np.arange(ppm)[:, None]
    i = np.arange(8)[None, :]
    sh = jnp.asarray((y - i) % ppm, dtype=jnp.int32)
    bits = (g[None, :] >> sh) & 1
    cw = jnp.sum(bits << jnp.asarray(i, dtype=jnp.int32), axis=1)
    # Hamming syndrome correction (decode masks, decode_impl.cc:36-43,197-222).
    p1 = _popcount8(cw & 0x2E) & 1
    p2 = _popcount8(cw & 0x4B) & 1
    p3 = _popcount8(cw & 0x17) & 1
    syndrome = (p3 << 2) | (p2 << 1) | p1
    fix_tbl = jnp.asarray(np.array([0, 0, 0, 0x08, 0, 0x04, 0x01, 0x02], np.int32))
    cw = cw ^ fix_tbl[syndrome]
    nib = cw & 0xF
    plen = (nib[0] << 4) | nib[1]
    crc = nib[2] & 1
    cr = nib[2] >> 1
    cks = (nib[3] << 4) | nib[4]
    valid = cks == _header_checksum_jnp(plen, nib[2] & 0xF)
    # Packet symbol count (demod_impl.cc:250; explicit header => -5*!h == 0).
    denom = sf - 2 * int(cfg.ldr)
    tmp = (2.0 * plen - sf + 7 + 4.0 * crc) / denom
    psl = 8 + jnp.maximum((4 + cr) * jnp.ceil(tmp).astype(jnp.int32), 0)
    return valid, plen, cr, crc, psl


class _State(NamedTuple):
    ptr: jnp.ndarray
    st: jnp.ndarray
    hist: jnp.ndarray          # int32[REQUIRED_PREAMBLE_CHIRPS]
    hist_len: jnp.ndarray
    sync_cnt: jnp.ndarray
    cfo: jnp.ndarray
    snr: jnp.ndarray           # peak/mean ratio at preamble detection
    syms: jnp.ndarray          # float32[MS]
    sym_cnt: jnp.ndarray
    pkt_sym_len: jnp.ndarray
    hdr_received: jnp.ndarray
    hdr_valid: jnp.ndarray
    pkt_start: jnp.ndarray     # sample index of preamble detection (buffer-local)
    base: jnp.ndarray          # global stream index of buffer sample 0
    out_syms: jnp.ndarray      # uint16[MP, MS]
    out_len: jnp.ndarray       # int32[MP]
    out_pos: jnp.ndarray       # int32[MP] packet start (global stream index)
    out_snr: jnp.ndarray       # float32[MP] peak/mean ratio at detection
    out_cnt: jnp.ndarray
    it: jnp.ndarray


def max_packet_symbols(cfg: LoraConfig) -> int:
    """Static bound on symbols per packet for buffer sizing.

    At least 9: the FSM (like the reference, demod_impl.cc:531-553) pushes a
    9th symbol while still in S_READ_HEADER before it can transition, so even
    an 8-symbol packet emits 9 symbols.
    """
    if not cfg.explicit_header:
        return max(
            calc_sym_num(cfg.payload_len, sf=cfg.sf, cr=cfg.cr, crc=cfg.crc,
                         ldr=cfg.ldr, explicit_header=False),
            9,
        )
    return max(
        calc_sym_num(255, sf=cfg.sf, cr=cr, crc=True, ldr=cfg.ldr,
                     explicit_header=True)
        for cr in range(1, 5)
    )


@lru_cache(maxsize=None)
def _machine(cfg: LoraConfig, max_packets: int):
    """The demod FSM transition function, shared by the whole-buffer and
    streaming drivers.  Returns (body, init_state)."""
    n = cfg.num_samples
    k = cfg.bin_size
    fac = cfg.fft_factor
    p = cfg.p
    nsym = cfg.num_symbols
    ms = max_packet_symbols(cfg)
    mp = max_packets
    lookback = (21 * n) // 4   # 5.25 symbols, CFO re-estimate (demod_impl.cc:486)

    drift_max = cfg.preamble_drift_max
    implicit_psl = 0 if cfg.explicit_header else cfg.packet_symbol_len()

    def init_state(base: int, ptr: int) -> _State:
        return _State(
            ptr=jnp.int32(ptr), st=jnp.int32(_RESET),
            hist=jnp.zeros(REQUIRED_PREAMBLE_CHIRPS, jnp.int32),
            hist_len=jnp.int32(0), sync_cnt=jnp.int32(0),
            cfo=jnp.float32(0.0), snr=jnp.float32(0.0),
            syms=jnp.zeros(ms, jnp.float32),
            sym_cnt=jnp.int32(0), pkt_sym_len=jnp.int32(implicit_psl),
            hdr_received=jnp.bool_(False), hdr_valid=jnp.bool_(False),
            pkt_start=jnp.int32(0), base=jnp.int32(base),
            out_syms=jnp.zeros((mp, ms), jnp.uint16),
            out_len=jnp.zeros(mp, jnp.int32),
            out_pos=jnp.full(mp, -1, jnp.int32),
            out_snr=jnp.zeros(mp, jnp.float32), out_cnt=jnp.int32(0),
            it=jnp.int32(0))

    def body(iq, s: _State):
        win = jax.lax.dynamic_slice(iq, (s.ptr, 0), (n, 2))
        midx, mval = up_peak(win, cfg)
        midx = midx.astype(jnp.int32)
        # Peak-to-mean of the ABS fold: the SNR proxy recorded at
        # detection (shares the zoom-DFT matmul with up_peak via CSE).
        sval, smean = up_peak_stats(win, cfg)

        hist = jnp.concatenate([midx[None], s.hist[:-1]])
        hist_len = jnp.minimum(s.hist_len + 1, REQUIRED_PREAMBLE_CHIRPS)

        nc = jnp.int32(n)
        st = s.st

        # ---- S_RESET: clear and go to PREFILL (demod_impl.cc:369-386).
        do_reset = st == _RESET
        hist_len = jnp.where(do_reset, 0, hist_len)
        sync_cnt = jnp.where(do_reset, 0, s.sync_cnt)
        sym_cnt = jnp.where(do_reset, 0, s.sym_cnt)
        hdr_received = jnp.where(do_reset, False, s.hdr_received)
        hdr_valid = jnp.where(do_reset, False, s.hdr_valid)
        st = jnp.where(do_reset, _PREFILL, st)

        # ---- S_PREFILL (demod_impl.cc:390-401).
        st = jnp.where((s.st == _PREFILL) & (hist_len >= REQUIRED_PREAMBLE_CHIRPS),
                       _DETECT, st)

        # ---- S_DETECT_PREAMBLE (demod_impl.cc:406-438).
        do_det = s.st == _DETECT
        pre_idx = hist[0]
        dis = _pmod(pre_idx - hist[1:], k)
        # mval > 0 gates out exactly-zero windows (halo padding); real noise
        # always has a positive peak, so this is a no-op on captures.
        pre_found = jnp.all((dis <= drift_max) | (dis >= k - drift_max)) & (mval > 0)
        det_hit = do_det & pre_found
        nc = jnp.where(det_hit, n - (p * pre_idx) // fac, nc)
        st = jnp.where(det_hit, _SFD, st)
        pkt_start = jnp.where(det_hit, s.ptr, s.pkt_start)
        snr = jnp.where(det_hit, sval / jnp.maximum(smean, 1e-20), s.snr)

        # ---- S_SFD_SYNC (demod_impl.cc:444-504).
        do_sfd = s.st == _SFD
        bail = do_sfd & (s.sync_cnt > DEMOD_SYNC_RECOVERY_COUNT)
        sync_cnt = jnp.where(do_sfd, sync_cnt + 1, sync_cnt)

        def sfd_compute(_):
            didx, dval = down_peak(win, cfg)
            didx = didx.astype(jnp.int32)
            detect = dval > mval
            idx = jnp.where(didx > k // 2, didx - k, didx)
            nc_f = 2.25 * n + p * idx.astype(jnp.float32) / 2.0 / fac
            nc_sfd = jnp.floor(nc_f + 0.5).astype(jnp.int32)
            cfo_start = jnp.maximum(s.ptr + nc_sfd - lookback, 0)
            cfo_win = jax.lax.dynamic_slice(iq, (cfo_start, 0), (n, 2))
            cidx, _ = up_peak(cfo_win, cfg)
            return detect, nc_sfd, cidx.astype(jnp.float32)

        detect, nc_sfd, cfo_new = jax.lax.cond(
            do_sfd, sfd_compute,
            lambda _: (jnp.bool_(False), jnp.int32(0), jnp.float32(0.0)),
            operand=None)
        nc = jnp.where(detect, nc_sfd, nc)
        cfo = jnp.where(detect, cfo_new, s.cfo)
        # Bail sets RESET, but an SFD hit in the same call overrides
        # (reference has no else between the two, demod_impl.cc:449-501).
        st = jnp.where(bail & ~detect, _RESET, st)
        st = jnp.where(detect, _HEADER, st)

        # ---- S_READ_HEADER (demod_impl.cc:508-554).
        do_hdr = s.st == _HEADER
        bin_idx = _fpmod((midx.astype(jnp.float32) - cfo) / fac, float(nsym))
        syms = jnp.where(do_hdr,
                         s.syms.at[jnp.minimum(sym_cnt, ms - 1)].set(bin_idx),
                         s.syms)
        sym_cnt = jnp.where(do_hdr, jnp.minimum(sym_cnt + 1, ms), sym_cnt)
        pkt_sym_len = s.pkt_sym_len

        if cfg.explicit_header:
            hdr_trigger = do_hdr & (sym_cnt == 8)

            def parse(_):
                comp8 = _dynamic_compensation(syms, jnp.int32(8), cfg)[:8]
                return _parse_header_jnp(comp8.astype(jnp.int32), cfg)

            valid, plen, hcr, hcrc, psl = jax.lax.cond(
                hdr_trigger, parse,
                lambda _: (jnp.bool_(False), jnp.int32(0), jnp.int32(0),
                           jnp.int32(0), jnp.int32(0)),
                operand=None)
            hdr_received = hdr_received | hdr_trigger
            hdr_valid = jnp.where(hdr_trigger, valid, hdr_valid)
            pkt_sym_len = jnp.where(hdr_trigger & valid, psl, pkt_sym_len)

            go = do_hdr & (sym_cnt > 8) & hdr_received
            st = jnp.where(go & ~hdr_valid, _RESET, st)
            st = jnp.where(go & hdr_valid, _PAYLOAD, st)
        else:
            pkt_sym_len = jnp.where(do_hdr, implicit_psl, pkt_sym_len)
            st = jnp.where(do_hdr & (sym_cnt > 8), _PAYLOAD, st)

        # ---- S_READ_PAYLOAD (demod_impl.cc:558-580).
        do_pay = s.st == _PAYLOAD
        done = do_pay & (s.sym_cnt >= pkt_sym_len)
        push = do_pay & ~done
        syms = jnp.where(push, syms.at[jnp.minimum(sym_cnt, ms - 1)].set(bin_idx), syms)
        sym_cnt = jnp.where(push, jnp.minimum(sym_cnt + 1, ms), sym_cnt)
        st = jnp.where(done, _OUT, st)

        # ---- S_OUT (demod_impl.cc:585-607).
        do_out = s.st == _OUT

        def emit(args):
            out_syms, out_len, out_pos, out_snr, out_cnt = args
            comp = _dynamic_compensation(syms, sym_cnt, cfg)
            row = jnp.minimum(out_cnt, mp - 1)
            keep = out_cnt < mp
            out_syms = out_syms.at[row].set(jnp.where(keep, comp, out_syms[row]))
            out_len = out_len.at[row].set(jnp.where(keep, sym_cnt, out_len[row]))
            out_pos = out_pos.at[row].set(
                jnp.where(keep, pkt_start + s.base, out_pos[row]))
            out_snr = out_snr.at[row].set(
                jnp.where(keep, snr, out_snr[row]))
            # out_cnt counts every completed packet (uncapped) so slot
            # overflow is observable; drivers report min(cnt, mp) live slots
            # and cnt - mp dropped (the reference only printf's, SURVEY §5).
            return out_syms, out_len, out_pos, out_snr, out_cnt + 1

        out_syms, out_len, out_pos, out_snr, out_cnt = jax.lax.cond(
            do_out, emit, lambda a: a,
            (s.out_syms, s.out_len, s.out_pos, s.out_snr, s.out_cnt))
        st = jnp.where(do_out, _RESET, st)

        return _State(
            ptr=s.ptr + nc, st=st, hist=hist, hist_len=hist_len,
            sync_cnt=sync_cnt, cfo=cfo, snr=snr, syms=syms, sym_cnt=sym_cnt,
            pkt_sym_len=pkt_sym_len, hdr_received=hdr_received,
            hdr_valid=hdr_valid, pkt_start=pkt_start, base=s.base,
            out_syms=out_syms, out_len=out_len, out_pos=out_pos,
            out_snr=out_snr, out_cnt=out_cnt, it=s.it + 1)

    return body, init_state


@lru_cache(maxsize=None)
def demod_fn(cfg: LoraConfig, num_samples_total: int, max_packets: int = 8):
    """Build the pure (unjitted) demodulator for a fixed input length —
    composable inside vmap/shard_map; see make_demodulator for the jitted
    single-stream wrapper.

    Returns fn(iq_ri float32[num_samples_total, 2]) ->
    (packets uint16[max_packets, MS], lengths int32[max_packets],
     positions int32[max_packets], count int32, dropped int32,
     snr float32[max_packets]) where ``dropped`` counts completed packets
    that found no free output slot and ``snr`` is the peak/mean detection
    ratio (see snr_db_estimate).
    """
    n = cfg.num_samples
    body, init_state = _machine(cfg, max_packets)
    pad_front = 6 * n          # GR history prefill (demod_impl.cc:130,299-301)
    total = pad_front + num_samples_total + n
    max_iters = 8 * (total // n) + 64

    def run(iq_ri):
        iq = jnp.concatenate([
            jnp.zeros((pad_front, 2), jnp.float32),
            iq_ri.astype(jnp.float32),
            jnp.zeros((n, 2), jnp.float32),
        ])
        init = init_state(base=-pad_front, ptr=pad_front)

        def cond(s: _State):
            return (s.ptr + n <= iq.shape[0]) & (s.it < max_iters)

        final = jax.lax.while_loop(cond, partial(body, iq), init)
        if _DEBUG_FINAL_STATE:
            return final
        mp = final.out_len.shape[0]
        return (final.out_syms, final.out_len, final.out_pos,
                jnp.minimum(final.out_cnt, mp),
                jnp.maximum(final.out_cnt - mp, 0), final.out_snr)

    return run


_DEBUG_FINAL_STATE = False


# ---------------------------------------------------------------------------
# Streaming driver: carried FSM state across fixed-size blocks.
# ---------------------------------------------------------------------------

def stream_tail_len(cfg: LoraConfig) -> int:
    """Carried history per block: covers the 5.25-symbol CFO lookback, the
    current symbol window, and slack — the GR ``set_history`` analog
    (demod_impl.cc:130)."""
    return 8 * cfg.num_samples


@lru_cache(maxsize=None)
def demod_stream_fn(cfg: LoraConfig, block_len: int, max_packets: int = 8):
    """Streaming demodulator: process the unbounded IQ stream in fixed
    ``block_len`` chunks with all FSM state (including partially received
    packets) carried between calls.

    Returns (step, init) where
    ``step(carry, block float32[block_len, 2]) -> (carry, outs)`` and outs is
    (packets, lengths, positions, count, dropped, snr) for packets
    *completed during this block* (positions are global stream sample
    indices).
    """
    n = cfg.num_samples
    tail_len = stream_tail_len(cfg)
    if block_len < n:
        raise ValueError(f"block_len must be >= one symbol ({n})")
    body, init_state = _machine(cfg, max_packets)
    buf_len = tail_len + block_len
    max_iters = 8 * (buf_len // n) + 64
    mp = max_packets

    def init():
        s = init_state(base=-tail_len, ptr=tail_len)
        tail = jnp.zeros((tail_len, 2), jnp.float32)
        return s, tail

    def step(carry, block):
        s, tail = carry
        iq = jnp.concatenate([tail, block.astype(jnp.float32)])
        # Fresh per-block output slots and iteration budget.
        s = s._replace(out_syms=jnp.zeros_like(s.out_syms),
                       out_len=jnp.zeros_like(s.out_len),
                       out_pos=jnp.full(mp, -1, jnp.int32),
                       out_snr=jnp.zeros_like(s.out_snr),
                       out_cnt=jnp.int32(0), it=jnp.int32(0))

        def cond(st: _State):
            return (st.ptr + n <= buf_len) & (st.it < max_iters)

        final = jax.lax.while_loop(cond, partial(body, iq), s)
        outs = (final.out_syms, final.out_len, final.out_pos,
                jnp.minimum(final.out_cnt, mp),
                jnp.maximum(final.out_cnt - mp, 0), final.out_snr)
        # Re-anchor coordinates for the next block: its buffer starts at the
        # current buffer's sample ``block_len``.
        shift = jnp.int32(block_len)
        final = final._replace(ptr=final.ptr - shift,
                               pkt_start=final.pkt_start - shift,
                               base=final.base + shift)
        new_tail = iq[-tail_len:]
        return (final, new_tail), outs

    return step, init


class StreamingDemodulator:
    """Host-facing stateful wrapper: feed arbitrary chunks, collect packets.

    The device step is jitted once per block size; partial packets survive
    chunk boundaries because the whole FSM state is carried, so no overlap
    re-processing is needed (unlike overlap-save batch mode)."""

    def __init__(self, cfg: LoraConfig, block_len: int | None = None,
                 max_packets: int = 8, pipelined: bool = False):
        self.cfg = cfg
        self.block_len = block_len or 64 * cfg.num_samples
        step, init = demod_stream_fn(cfg, self.block_len, max_packets)
        self._step = jax.jit(step)
        self._carry = init()
        self._pending = np.zeros((0, 2), np.float32)
        #: Completed packets that overflowed the per-block output slots
        #: (raise ``max_packets`` if this ever becomes nonzero).
        self.dropped = 0
        #: Peak/mean SNR-proxy ratio for the packets returned by the MOST
        #: RECENT feed()/flush() call, in order (convert with
        #: snr_db_estimate); reset at each call so it cannot grow without
        #: bound on long streams.
        self.snr_ratios: list[float] = []
        # Double buffering: jax dispatch is async, so with ``pipelined`` the
        # device computes block i while the host prepares block i+1 — the
        # fetch of block i's packets happens on the NEXT feed call (results
        # shift one block later; flush() always drains).  This is the
        # host<->device overlap of the GR scheduler's block threads.
        self._pipelined = pipelined
        self._inflight = None

    def _drain_outs(self, outs) -> list[tuple[int, np.ndarray]]:
        syms, lens, pos, cnt, dropped, snr = (
            np.asarray(x) for x in jax.device_get(outs))
        self.dropped += int(dropped)
        self.snr_ratios += [float(snr[r]) for r in range(int(cnt))]
        return [(int(pos[r]), syms[r, :lens[r]].copy())
                for r in range(int(cnt))]

    def feed(self, iq) -> list[tuple[int, np.ndarray]]:
        """Consume IQ (complex or [T, 2] float32); returns completed packets
        as (global_position, symbols) tuples."""
        self.snr_ratios = []
        if np.iscomplexobj(iq):
            iq = to_ri(np.asarray(iq))
        buf = np.concatenate([self._pending,
                              np.asarray(iq, np.float32).reshape(-1, 2)])
        out: list[tuple[int, np.ndarray]] = []
        nfull = buf.shape[0] // self.block_len
        for b in range(nfull):
            block = buf[b * self.block_len:(b + 1) * self.block_len]
            self._carry, outs = self._step(self._carry, block)
            if self._pipelined:
                if self._inflight is not None:
                    out += self._drain_outs(self._inflight)
                self._inflight = outs
            else:
                out += self._drain_outs(outs)
        self._pending = buf[nfull * self.block_len:]
        return out

    def flush(self) -> list[tuple[int, np.ndarray]]:
        """Pad the residue with silence and drain in-flight packets."""
        drain = self.block_len + 2 * stream_tail_len(self.cfg)
        pad = (-(self._pending.shape[0] + drain)) % self.block_len
        silence = np.zeros((drain + pad, 2), np.float32)
        out = self.feed(silence)          # resets snr_ratios for this call
        if self._inflight is not None:
            out += self._drain_outs(self._inflight)
            self._inflight = None
        return out

    # -- checkpoint/resume: the FSM state is an explicit pytree, so resuming
    #    from any block boundary is a pure array save/restore (the reference
    #    has no equivalent; SURVEY.md §5 "Checkpoint/resume").
    def state_dict(self) -> dict:
        leaves, _ = jax.tree.flatten(self._carry)
        d = {f"carry_{i}": np.asarray(jax.device_get(x))
             for i, x in enumerate(leaves)}
        d["pending"] = self._pending.copy()
        return d

    def load_state_dict(self, d: dict) -> None:
        leaves, treedef = jax.tree.flatten(self._carry)
        new = [jnp.asarray(d[f"carry_{i}"]) for i in range(len(leaves))]
        self._carry = jax.tree.unflatten(treedef, new)
        self._pending = np.asarray(d["pending"], np.float32).copy()


@lru_cache(maxsize=None)
def make_demodulator(cfg: LoraConfig, num_samples_total: int, max_packets: int = 8):
    """Jitted demodulator for a fixed input length.

    Returns fn(iq_ri float32[num_samples_total, 2]) ->
    (packets uint16[max_packets, MS], lengths int32[max_packets],
     positions int32[max_packets], count int32, dropped int32,
     snr float32[max_packets]).
    """
    return jax.jit(demod_fn(cfg, num_samples_total, max_packets))


def demodulate(iq, cfg: LoraConfig, max_packets: int = 8):
    """Convenience host API: complex64 (or [T,2] float32) IQ -> list of
    uint16 symbol arrays, one per detected packet."""
    if np.iscomplexobj(iq):
        iq = to_ri(np.asarray(iq))
    iq = np.asarray(iq, dtype=np.float32)
    fn = make_demodulator(cfg, iq.shape[0], max_packets)
    out_syms, out_len, _, out_cnt, _, _ = jax.device_get(fn(iq))
    return [out_syms[i, :out_len[i]].copy() for i in range(int(out_cnt))]


def snr_db_estimate(ratio, cfg: LoraConfig):
    """Convert the FSM's peak/mean detection ratio to an in-band SNR
    estimate in dB.

    For a tone of amplitude A in complex noise of per-component std s at
    fs = p*bw: peak = N*A, and the mean folded-bin magnitude is
    2*s*sqrt(N)*sqrt(pi/2) (Rayleigh mean of two folded bands), so
    in-band SNR = A^2 p / (2 s^2) = (pi p / N) * ratio^2.
    """
    n = cfg.num_samples
    r = np.maximum(np.asarray(ratio, np.float64), 1e-12)
    return 10.0 * np.log10(np.pi * cfg.p / n * r * r)
