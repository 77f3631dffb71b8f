"""Weak-signal demodulator: non-coherent two-copy combining (+3 dB).

Re-expression of the reference weak_demod block (lib/weak_demod_impl.cc) as
a jitted lax.while_loop FSM, sharing the zoom-DFT matmul ops with the plain
demodulator.  The waveform carries every symbol **twice**; each peak search
sums the folded dechirped-FFT magnitudes of two consecutive symbol periods
before the argmax (weak_demod_impl.cc:172-194), halving the required SNR.

Payload layout consumed by the reference FSM (weak_demod_impl.cc:398-438):
two double-symbols, a 4-symbol-period skip ("checksum of header symbols"),
then repeating [double-symbol, double-symbol, 1-period skip].  Packet length
is the explicit ``sym_num`` parameter — there is no header feedback
(parse_header is a stub, weak_demod_impl.cc:144-146).

``modulate_weak`` generates the matching waveform so the path is
loopback-testable (the reference ships no weak transmitter).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    WEAK_DEMOD_SYNC_RECOVERY_COUNT,
    WEAK_REQUIRED_PREAMBLE_CHIRPS,
    LoraConfig,
)
from ..models.modulator import NUM_PREAMBLE_CHIRPS
from ..ops.chirp import chirp_tables
from ..ops.cplx import cmag, to_ri
from ..ops.dechirp import down_bands, up_bands

_RESET, _PREFILL, _DETECT, _SFD, _PAYLOAD, _OUT = range(6)


def _fpmod(x, n):
    return jnp.mod(jnp.mod(x, n) + n, n)


# ---------------------------------------------------------------------------
# Weak-mode TX (fixture generator).
# ---------------------------------------------------------------------------

def modulate_weak(symbols: np.ndarray, cfg: LoraConfig, p: int | None = None,
                  pad_front: int | None = None,
                  pad_back: int | None = None) -> np.ndarray:
    """Symbols -> weak-mode IQ: preamble | sync | SFD | s0 s0 s1 s1 |
    4 filler periods | [s2 s2 s3 s3 filler] ... — the layout the weak FSM's
    consume pattern expects (weak_demod_impl.cc:398-438)."""
    p = cfg.p if p is None else p
    up, down = chirp_tables(cfg.sf, p)
    n = p << cfg.sf
    if pad_front is None:
        pad_front = 4 * n
    if pad_back is None:
        pad_back = 4 * n + 128 * p

    i = np.arange(n)
    chunks = [np.zeros(pad_front, dtype=np.complex64)]
    chunks.append(np.tile(up, NUM_PREAMBLE_CHIRPS))
    for nib in ((cfg.sync_word & 0xF0) >> 4, cfg.sync_word & 0x0F):
        chunks.append(up[(8 * nib * p + i) % n])
    j = np.arange(2 * n + n // 4)
    chunks.append(down[j % n])

    filler = np.zeros(n, dtype=np.complex64)
    syms = list(np.asarray(symbols, dtype=np.int64))

    def dbl(s):
        c = up[(int(s) * p + i) % n]
        return np.concatenate([c, c])

    for k, s in enumerate(syms):
        chunks.append(dbl(s))
        if k == 1:
            chunks.extend([filler] * 4)          # header-checksum skip (4 periods)
        elif k >= 2 and (k % 2) == 1:
            chunks.append(filler)                # 1-period skip after each pair
    chunks.append(np.zeros(pad_back, dtype=np.complex64))
    return np.concatenate(chunks).astype(np.complex64)


def weak_packet_duration(sym_num: int, cfg: LoraConfig, p: int | None = None) -> int:
    p = cfg.p if p is None else p
    n = p << cfg.sf
    periods = 0
    for k in range(sym_num):
        periods += 2
        if k == 1:
            periods += 4
        elif k >= 2 and (k % 2) == 1:
            periods += 1
    return (NUM_PREAMBLE_CHIRPS + 2) * n + (2 * n + n // 4) + periods * n


# ---------------------------------------------------------------------------
# Jitted FSM.
# ---------------------------------------------------------------------------

def _pair_peak(win2, cfg: LoraConfig, *, down: bool):
    """[2n, 2] window -> (argmax, val) of the summed folded spectra of its
    two symbol periods (weak_demod_impl.cc:172-194)."""
    n = cfg.num_samples
    w = win2.reshape(2, n, 2)
    bands = down_bands(w, cfg) if down else up_bands(w, cfg)
    lo, hi = bands
    folded = (cmag(lo) + cmag(hi)).sum(axis=0)
    idx = jnp.argmax(folded, axis=-1)
    return idx.astype(jnp.int32), folded[idx]


class _State(NamedTuple):
    ptr: jnp.ndarray
    st: jnp.ndarray
    hist: jnp.ndarray
    hist_len: jnp.ndarray
    sync_cnt: jnp.ndarray
    cfo: jnp.ndarray
    syms: jnp.ndarray
    sym_cnt: jnp.ndarray       # symbols pushed
    iter_cnt: jnp.ndarray      # payload FSM iterations (reference sym_cnt)
    out_syms: jnp.ndarray
    out_len: jnp.ndarray
    out_cnt: jnp.ndarray
    it: jnp.ndarray


def _dynamic_compensation(symbols, count, cfg: LoraConfig):
    """Reference weak_demod_impl.cc:196-217: modulus = ldr ? 4 : 1, always
    applied (unlike the plain demod, which zeroes it when !ldr).  With
    cfg.weak_compensation == "ldr-only" the !ldr integrator is disabled
    (beyond-reference; see config.py — the modulus-1 integrator random-walks
    on noisy fractional bins and costs packet-perfect sensitivity)."""
    nsym = float(cfg.num_symbols)
    modulus = 4.0 if cfg.ldr else 1.0
    disabled = cfg.weak_compensation == "ldr-only" and not cfg.ldr

    def step(carry, xs):
        v_last, comp = carry
        v, i = xs
        drift = _fpmod(v - v_last, modulus)
        comp_new = comp - jnp.where(drift < modulus / 2, drift, drift - modulus)
        if disabled:
            comp_new = jnp.float32(0.0)
        valid = i < count
        comp2 = jnp.where(valid, comp_new, comp)
        v_last2 = jnp.where(valid, v, v_last)
        out = jnp.mod(jnp.floor(_fpmod(v + comp2, nsym) + 0.5), nsym)
        return (v_last2, comp2), out

    ms = symbols.shape[0]
    (_, _), outs = jax.lax.scan(
        step, (jnp.float32(1.0), jnp.float32(0.0)),
        (symbols, jnp.arange(ms, dtype=jnp.int32)))
    outs = jnp.where(jnp.arange(ms) < count, outs, 0)
    return outs.astype(jnp.uint16)


@lru_cache(maxsize=None)
def _weak_machine(cfg: LoraConfig, max_packets: int):
    """The weak FSM transition function, shared by the whole-buffer and
    streaming drivers.  Returns (body, init_state)."""
    n = cfg.num_samples
    k = cfg.bin_size
    fac = cfg.fft_factor
    p = cfg.p
    nsym = cfg.num_symbols
    ms = cfg.weak_sym_num
    mp = max_packets
    drift_max = cfg.preamble_drift_max
    npre = WEAK_REQUIRED_PREAMBLE_CHIRPS

    def init_state(ptr: int) -> _State:
        return _State(
            ptr=jnp.int32(ptr), st=jnp.int32(_RESET),
            hist=jnp.zeros(npre, jnp.int32), hist_len=jnp.int32(0),
            sync_cnt=jnp.int32(0), cfo=jnp.float32(0.0),
            syms=jnp.zeros(ms, jnp.float32), sym_cnt=jnp.int32(0),
            iter_cnt=jnp.int32(0),
            out_syms=jnp.zeros((mp, ms), jnp.uint16),
            out_len=jnp.zeros(mp, jnp.int32), out_cnt=jnp.int32(0),
            it=jnp.int32(0))

    def body(iq, s: _State):
        win2 = jax.lax.dynamic_slice(iq, (s.ptr, 0), (2 * n, 2))
        midx, mval = _pair_peak(win2, cfg, down=False)

        push_hist = mval > 0
        hist = jnp.where(push_hist,
                         jnp.concatenate([midx[None], s.hist[:-1]]), s.hist)
        hist_len = jnp.where(push_hist,
                             jnp.minimum(s.hist_len + 1, npre), s.hist_len)

        nc = jnp.int32(n)
        st = s.st

        # WS_RESET (weak_demod_impl.cc:278-296).
        do_reset = st == _RESET
        hist_len = jnp.where(do_reset, 0, hist_len)
        sync_cnt = jnp.where(do_reset, 0, s.sync_cnt)
        sym_cnt = jnp.where(do_reset, 0, s.sym_cnt)
        iter_cnt = jnp.where(do_reset, 0, s.iter_cnt)
        st = jnp.where(do_reset, _PREFILL, st)

        # WS_PREFILL (:299-309).
        st = jnp.where((s.st == _PREFILL) & (hist_len >= npre), _DETECT, st)

        # WS_DETECT_PREAMBLE (:312-349).
        do_det = s.st == _DETECT
        pre_idx = hist[0]
        dis = jnp.mod(pre_idx - hist[1:] + k, k)
        pre_found = jnp.all((dis <= drift_max) | (dis >= k - drift_max)) & (mval > 0)
        det_hit = do_det & pre_found
        nc = jnp.where(det_hit, n - (p * pre_idx) // fac, nc)
        st = jnp.where(det_hit, _SFD, st)

        # WS_SFD_SYNC (:352-399).
        do_sfd = s.st == _SFD
        bail = do_sfd & (s.sync_cnt > WEAK_DEMOD_SYNC_RECOVERY_COUNT)
        sync_cnt = jnp.where(do_sfd, sync_cnt + 1, sync_cnt)

        def sfd_compute(_):
            d0_idx, d0_val = _pair_peak(win2, cfg, down=True)
            win2b = jax.lax.dynamic_slice(iq, (s.ptr + n, 0), (2 * n, 2))
            _, d1_val = _pair_peak(win2b, cfg, down=True)
            # Reference: only the i==0 branch can sync (:377-380).
            detect = (d0_val >= d1_val) & (d0_val > mval)
            off = jnp.where(d0_idx > k // 2, d0_idx - k, d0_idx)
            nc_f = 2.25 * n + p * off.astype(jnp.float32) / 2.0 / fac
            nc_sfd = jnp.floor(nc_f + 0.5).astype(jnp.int32)
            cfo_start = jnp.maximum(s.ptr + nc_sfd - (25 * n) // 4, 0)
            cfo_win = jax.lax.dynamic_slice(iq, (cfo_start, 0), (2 * n, 2))
            cidx, _ = _pair_peak(cfo_win, cfg, down=False)
            return detect, nc_sfd, cidx.astype(jnp.float32)

        detect, nc_sfd, cfo_new = jax.lax.cond(
            do_sfd, sfd_compute,
            lambda _: (jnp.bool_(False), jnp.int32(0), jnp.float32(0.0)),
            operand=None)
        nc = jnp.where(detect, nc_sfd, nc)
        cfo = jnp.where(detect, cfo_new, s.cfo)
        st = jnp.where(bail & ~detect, _RESET, st)
        st = jnp.where(detect, _PAYLOAD, st)

        # WS_READ_PAYLOAD (:402-447): consume pattern over iter_cnt.
        do_pay = s.st == _PAYLOAD
        done = do_pay & (s.sym_cnt >= ms)
        active = do_pay & ~done
        bin_idx = _fpmod((midx.astype(jnp.float32) - cfo) / fac, float(nsym))
        first_two = s.iter_cnt < 2
        cksum_skip = s.iter_cnt == 2
        later_skip = (s.iter_cnt >= 3) & (jnp.mod(s.iter_cnt - 3, 3) == 2)
        push = active & (first_two | ((s.iter_cnt >= 3) & ~later_skip))
        nc = jnp.where(active,
                       jnp.where(cksum_skip, 4 * n,
                                 jnp.where(later_skip, n, 2 * n)), nc)
        syms = jnp.where(push,
                         s.syms.at[jnp.minimum(sym_cnt, ms - 1)].set(bin_idx),
                         s.syms)
        sym_cnt = jnp.where(push, jnp.minimum(sym_cnt + 1, ms), sym_cnt)
        iter_cnt = jnp.where(active, iter_cnt + 1, iter_cnt)
        st = jnp.where(done, _OUT, st)

        # WS_OUT (:451-471).
        do_out = s.st == _OUT

        def emit(args):
            out_syms, out_len, out_cnt = args
            comp = _dynamic_compensation(syms, sym_cnt, cfg)
            row = jnp.minimum(out_cnt, mp - 1)
            keep = out_cnt < mp
            out_syms = out_syms.at[row].set(jnp.where(keep, comp, out_syms[row]))
            out_len = out_len.at[row].set(jnp.where(keep, sym_cnt, out_len[row]))
            return out_syms, out_len, out_cnt + 1  # uncapped: overflow visible

        out_syms, out_len, out_cnt = jax.lax.cond(
            do_out, emit, lambda a: a, (s.out_syms, s.out_len, s.out_cnt))
        st = jnp.where(do_out, _RESET, st)

        return _State(ptr=s.ptr + nc, st=st, hist=hist, hist_len=hist_len,
                      sync_cnt=sync_cnt, cfo=cfo, syms=syms, sym_cnt=sym_cnt,
                      iter_cnt=iter_cnt, out_syms=out_syms, out_len=out_len,
                      out_cnt=out_cnt, it=s.it + 1)

    return body, init_state


@lru_cache(maxsize=None)
def weak_demod_fn(cfg: LoraConfig, num_samples_total: int, max_packets: int = 4):
    """Pure fn(iq_ri [T, 2]) -> (syms uint16[MP, sym_num], lens, count,
    dropped) — ``dropped`` counts packets that overflowed the slots."""
    n = cfg.num_samples
    mp = max_packets
    body, init_state = _weak_machine(cfg, max_packets)
    pad_front = 13 * n        # history prefill (WEAK_DEMOD_HISTORY=7 + slack)
    total = pad_front + num_samples_total + 4 * n
    max_iters = 4 * (total // n) + 64

    def run(iq_ri):
        iq = jnp.concatenate([
            jnp.zeros((pad_front, 2), jnp.float32),
            iq_ri.astype(jnp.float32),
            jnp.zeros((4 * n, 2), jnp.float32),
        ])
        init = init_state(pad_front)

        def cond(s: _State):
            return (s.ptr + 2 * n <= iq.shape[0]) & (s.it < max_iters)

        final = jax.lax.while_loop(cond, partial(body, iq), init)
        return (final.out_syms, final.out_len,
                jnp.minimum(final.out_cnt, mp),
                jnp.maximum(final.out_cnt - mp, 0))

    return run


@lru_cache(maxsize=None)
def weak_stream_fn(cfg: LoraConfig, block_len: int, max_packets: int = 4):
    """Streaming weak demodulator: fixed blocks, carried FSM state — the
    GR-streaming analog of the reference weak_demod block.

    The carried tail must cover the 25n/4 CFO look-back plus the pair
    window; the FSM stops 3n before the buffer end because the SFD branch
    reads one symbol ahead of its 2n pair window (unprocessed samples ride
    into the next block's tail).
    """
    n = cfg.num_samples
    tail_len = 16 * n
    if block_len < 4 * n:
        raise ValueError(f"block_len must be >= 4 symbols ({4 * n})")
    body, init_state = _weak_machine(cfg, max_packets)
    buf_len = tail_len + block_len
    max_iters = 4 * (buf_len // n) + 64
    mp = max_packets

    def init():
        return init_state(tail_len), jnp.zeros((tail_len, 2), jnp.float32)

    def step(carry, block):
        s, tail = carry
        iq = jnp.concatenate([tail, block.astype(jnp.float32)])
        s = s._replace(out_syms=jnp.zeros_like(s.out_syms),
                       out_len=jnp.zeros_like(s.out_len),
                       out_cnt=jnp.int32(0), it=jnp.int32(0))

        def cond(st: _State):
            return (st.ptr + 3 * n <= buf_len) & (st.it < max_iters)

        final = jax.lax.while_loop(cond, partial(body, iq), s)
        outs = (final.out_syms, final.out_len,
                jnp.minimum(final.out_cnt, mp),
                jnp.maximum(final.out_cnt - mp, 0))
        final = final._replace(ptr=final.ptr - jnp.int32(block_len))
        return (final, iq[-tail_len:]), outs

    return step, init


class StreamingWeakDemodulator:
    """Host-facing stateful wrapper: feed chunks, collect weak packets."""

    def __init__(self, cfg: LoraConfig, block_len: int | None = None,
                 max_packets: int = 4):
        self.cfg = cfg
        self.block_len = block_len or 64 * cfg.num_samples
        step, init = weak_stream_fn(cfg, self.block_len, max_packets)
        self._step = jax.jit(step)
        self._carry = init()
        self._pending = np.zeros((0, 2), np.float32)
        self.dropped = 0

    def feed(self, iq) -> list[np.ndarray]:
        if np.iscomplexobj(iq):
            iq = to_ri(np.asarray(iq))
        buf = np.concatenate([self._pending,
                              np.asarray(iq, np.float32).reshape(-1, 2)])
        out: list[np.ndarray] = []
        nfull = buf.shape[0] // self.block_len
        for b in range(nfull):
            block = buf[b * self.block_len:(b + 1) * self.block_len]
            self._carry, outs = self._step(self._carry, block)
            syms, lens, cnt, dropped = (
                np.asarray(x) for x in jax.device_get(outs))
            self.dropped += int(dropped)
            out += [syms[r, :lens[r]].copy() for r in range(int(cnt))]
        self._pending = buf[nfull * self.block_len:]
        return out

    def flush(self) -> list[np.ndarray]:
        drain = self.block_len + 40 * self.cfg.num_samples
        pad = (-(self._pending.shape[0] + drain)) % self.block_len
        return self.feed(np.zeros((drain + pad, 2), np.float32))


@lru_cache(maxsize=None)
def make_weak_demodulator(cfg: LoraConfig, num_samples_total: int,
                          max_packets: int = 4):
    return jax.jit(weak_demod_fn(cfg, num_samples_total, max_packets))


def weak_demodulate(iq, cfg: LoraConfig, max_packets: int = 4):
    """Host API: IQ -> list of uint16 symbol arrays (length cfg.weak_sym_num)."""
    if np.iscomplexobj(iq):
        iq = to_ri(np.asarray(iq))
    iq = np.asarray(iq, dtype=np.float32)
    fn = make_weak_demodulator(cfg, iq.shape[0], max_packets)
    out_syms, out_len, out_cnt, _ = jax.device_get(fn(iq))
    return [out_syms[i, :out_len[i]].copy() for i in range(int(out_cnt))]
