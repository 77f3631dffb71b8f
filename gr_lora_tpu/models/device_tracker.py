"""On-device Pyramid peak tracking: only finished packets leave the device.

The host tracker (models/pyramid.PyramidTracker — the behavior spec, after
reference pyramid_demod_impl.cc:225-767) walks the dense [hops, max_peaks]
peak lattice one hop at a time, which forces the whole lattice through the
device->host link (~tens of KB per decoded packet).  This module re-expresses the identical state machine as a jittable
``lax.scan`` over hops with masked fixed-size pools, so the lattice is
consumed where it is produced and only *finished packets* (symbol vectors,
lengths, preamble timestamps — ~100 B each) are ever fetched.

State-machine parity (same rules, same order semantics):

- peak -> track matching scans the hop's peaks in ascending-bin order and
  takes the FIRST matching live track in insertion order (reference :227,
  :241-247); insertion order is materialized as a per-slot sequence number
  so pool-slot reuse cannot reorder matches.
- track classification (preamble / data / broken, get_central_peak
  :319-391) runs on a per-track ring of the last 16 peaks plus the pinned
  h[16:32] slice: every reference rule reads only the final
  ``overlaps + overlaps/2`` trajectory entries, the first ``2*overlaps``
  entries (data tracks), or that fixed slice — proven in _classify below.
- packet matching (add_symbol_to_packet :393-473) minimizes the ts-phase
  distance with the 0.5 height gate, first-minimum in packet insertion
  order.
- assembly (general_work :680-767) sorts by normalized timestamp and walks
  4.5-symbol-offset windows; the walk is densified to a [windows, peaks]
  mask with the reference's exact termination rule (stop at the first
  window that is empty or beyond the last peak).

Bounded-pool deviations (each surfaced as a counter, zero on every test
fixture): at most ``finalize_per_hop`` track retirements and
``expire_per_hop`` packet expiries are applied per hop (extras are
processed on the following hops — a delay, not a loss), and a packet
stores at most ``max_symbols`` peaks.  The apex estimator is the
reference's compiled-in SEGMENT algorithm (pyramid_demod.h:32-35).

Floating-point parity: heights flow in f32 exactly as the C++ reference
(and native/src/pyramid_tracker.cc) computes them; the pure-Python host
tracker incidentally promotes to f64, so near-exact ties at the 0.5
height gate could in principle resolve differently — the fuzz test
(tests/test_device_tracker.py) bounds this empirically.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    PYRAMID_MAX_TRACK_PEAKS,
    PYRAMID_NUM_PREAMBLE,
    PYRAMID_OVERLAP_FACTOR,
    PYRAMID_PACKET_POOL,
    TIMESTAMP_MOD,
    LoraConfig,
)

_OV = PYRAMID_OVERLAP_FACTOR
_RING = 2 * _OV                     # last-16 peak ring (see module doc)
_MID_LO = 2 * _OV                   # stable-height slice [16:32) (:373-378)
_MID_HI = _OV * (PYRAMID_NUM_PREAMBLE - 2)
_PRE_MIN = _OV * (PYRAMID_NUM_PREAMBLE - 1) + 2   # :316
_DATA_MAX = 2 * _OV                 # :332
_TTL0 = 6 * _OV                     # :95
_IMAX = np.int32(np.iinfo(np.int32).max)
_KIND_PRE, _KIND_DATA, _KIND_BROKEN = 0, 1, 2


def _at_set(arr, idx, cond, val):
    """arr[idx] = val where cond else unchanged (scalar idx)."""
    return arr.at[idx].set(jnp.where(cond, val, arr[idx]))


def flush_hops(grace: int = 0) -> int:
    """Empty hops needed to retire every live track and expire every
    packet (host PyramidTracker.flush_hops analog)."""
    return (PYRAMID_NUM_PREAMBLE + 3) * _OV + _TTL0 + 2 + grace


@lru_cache(maxsize=None)
def make_device_tracker(cfg: LoraConfig, max_peaks: int = 16,
                        grace: int = 0, track_pool: int = 64,
                        packet_pool: int = PYRAMID_PACKET_POOL,
                        max_symbols: int = 96, out_pool: int = 32,
                        finalize_per_hop: int = 8, expire_per_hop: int = 4,
                        split_repeats: bool = False,
                        quantize: str = "round"):
    """Build (init_state, process) for one tracker.

    ``process(state, bins, h, hs, valid)`` consumes a [H, max_peaks] peak
    lattice block (any H; one specialization per H) and returns the new
    state; finished packets accumulate in ``state['o_*']`` until the
    caller drains them (DevicePyramidTracker).  Pure functions — compose
    under jit / vmap / shard_map (e.g. one tracker per channel).

    ``track_pool`` defaults to 64 (not the reference's 1000-track
    worst-case pool): a pool overflow only *drops counters*, never
    corrupts state, and 64 covers >16 simultaneous colliding packets.
    """
    K, Q, S, O = track_pool, packet_pool, max_symbols, out_pool
    F, E, M = finalize_per_hop, expire_per_hop, max_peaks
    W = S + 1                       # max assembly windows: S found + 1 miss
    n = cfg.num_samples
    k = cfg.bin_size
    hop = n // _OV
    tol = cfg.bin_tolerance
    thr = jnp.float32(cfg.threshold)
    ff = cfg.fft_factor
    #: bin->symbol quantization offset: 'round' (default; deliberate
    #: deviation, see models/pyramid.py _assemble) vs the bit-true
    #: reference floor rule (pyramid_demod_impl.cc:744).
    assert quantize in ("floor", "round"), quantize
    qoff = ff // 2 if quantize == "round" else 0
    lo0 = 4 * n + n // 2            # first data-symbol window (:680-684)
    i32 = jnp.int32
    #: split_repeats (models/pyramid.PyramidTracker twin): the per-track
    #: peak ring must hold a whole merged run (up to the preamble-length
    #: disambiguation cap, ov*(num_preamble+1) peaks) instead of just the
    #: classification window; classification still reads only the last
    #: 2*ov entries, so reference-exact semantics are unchanged.
    R = _OV * (PYRAMID_NUM_PREAMBLE + 1) if split_repeats else _RING
    #: Max split groups per retired track (+1 entry for the normal path).
    G = (R - 1) // _OV + 1 if split_repeats else 0

    def init_state():
        z = partial(jnp.zeros, dtype=jnp.int32)
        zf = partial(jnp.zeros, dtype=jnp.float32)
        zb = partial(jnp.zeros, dtype=bool)
        return {
            # tracks
            "t_active": zb(K), "t_seq": z(K), "t_bin": z(K),
            "t_count": z(K), "t_updated": zb(K), "t_misses": z(K),
            "t_ring_ts": z((K, R)), "t_ring_bin": z((K, R)),
            "t_ring_h": zf((K, R)), "t_ring_hs": zf((K, R)),
            "t_mid_h": zf((K, _MID_HI - _MID_LO)),
            # split-mode carry: did the current candidate's first split
            # peak phase-match an existing packet? (gates its tail peaks)
            "s_gate": jnp.array(False),
            # packets
            "p_active": zb(Q), "p_seq": z(Q), "p_ttl": z(Q),
            "p_pre_ts": z(Q), "p_pre_bin": z(Q),
            "p_pre_h": jnp.ones(Q, jnp.float32),
            "p_count": z(Q),
            "p_ts": z((Q, S)), "p_bin": z((Q, S)), "p_h": zf((Q, S)),
            # outputs
            "o_count": i32(0), "o_len": z(O), "o_pos": z(O),
            "o_syms": z((O, W)),
            # clocks & counters
            "ts_ref": i32(0), "bin_ref": i32(0),
            "tseq": i32(0), "pseq": i32(0),
            "tracks_dropped": i32(0), "packets_dropped": i32(0),
            "tracks_overflow_finalized": i32(0),
            "finalize_deferred": i32(0), "expire_deferred": i32(0),
            "packet_peak_overflow": i32(0), "out_overflow": i32(0),
        }

    # -- peak -> track matching (find_and_add_peak :225-272) -------------
    def peak_step(st, x):
        b, hv, hsv, v = x
        cur = (k + b - st["bin_ref"]) % k
        d = (cur - st["t_bin"]) % k
        match = st["t_active"] & ((d <= tol) | (d >= k - tol))
        any_m = match.any()
        mi = jnp.argmin(jnp.where(match, st["t_seq"], _IMAX))
        free = ~st["t_active"]
        any_f = free.any()
        fi = jnp.argmax(free)
        creating = v & ~any_m & any_f
        do = v & (any_m | any_f)
        idx = jnp.where(any_m, mi, fi)

        st["t_active"] = _at_set(st["t_active"], idx, do, True)
        st["t_seq"] = _at_set(st["t_seq"], idx, creating, st["tseq"])
        st["t_bin"] = _at_set(st["t_bin"], idx, creating, cur)
        st["t_misses"] = _at_set(st["t_misses"], idx, creating, 0)
        st["t_updated"] = _at_set(st["t_updated"], idx, do, True)
        cnt0 = jnp.where(creating, 0, st["t_count"][idx])
        slot = cnt0 % R
        st["t_ring_ts"] = _at_set(st["t_ring_ts"], (idx, slot), do,
                                  st["ts_ref"])
        st["t_ring_bin"] = _at_set(st["t_ring_bin"], (idx, slot), do, b)
        st["t_ring_h"] = _at_set(st["t_ring_h"], (idx, slot), do, hv)
        st["t_ring_hs"] = _at_set(st["t_ring_hs"], (idx, slot), do, hsv)
        mid_j = jnp.clip(cnt0 - _MID_LO, 0, _MID_HI - _MID_LO - 1)
        in_mid = (cnt0 >= _MID_LO) & (cnt0 < _MID_HI)
        st["t_mid_h"] = _at_set(st["t_mid_h"], (idx, mid_j), do & in_mid, hv)
        st["t_count"] = _at_set(st["t_count"], idx, do, cnt0 + 1)
        st["tseq"] += creating.astype(jnp.int32)
        st["tracks_dropped"] += (v & ~any_m & ~any_f).astype(jnp.int32)
        return st, None

    # -- track classification (get_central_peak :319-391) ----------------
    def classify(count, ring_ts, ring_bin, ring_h, ring_hs, mid_h):
        # Reference-exact classification reads only the LAST 2*ov peaks
        # regardless of the physical ring size R (split mode keeps more
        # history for split_extract, never for classification).
        base = count - _RING
        idxs = (base + jnp.arange(_RING)) % R
        lin_ts = ring_ts[idxs]
        lin_bin = ring_bin[idxs]
        lin_h = ring_h[idxs]
        lin_hs = ring_hs[idxs]
        lin_valid = (base + jnp.arange(_RING)) >= 0

        # DATA (2 <= ln <= 16): SEGMENT apex = first argmax of h (:274-279).
        di = jnp.argmax(jnp.where(lin_valid, lin_h, -jnp.inf))
        data = (lin_ts[di], lin_bin[di], lin_h[di])

        # PREAMBLE (ln >= 42 -> full ring valid): apex of the LAST chirp,
        # walked back along the single-peak trajectory (:349-379).
        r_lo = _RING - _OV
        r_idx = jnp.argmax(jnp.where(jnp.arange(_RING) >= r_lo, lin_h,
                                     -jnp.inf))

        def wb(_, c):
            start, stop = c
            in_loop = ~stop & (start > r_idx - _OV // 2)
            brk = ((lin_hs[jnp.maximum(start - 1, 0)] > lin_hs[start])
                   | (lin_hs[start] < thr))
            return (jnp.where(in_loop & ~brk, start - 1, start),
                    stop | ~in_loop | brk)

        start, _ = jax.lax.fori_loop(0, _OV // 2, wb, (r_idx, False))
        ai = jnp.argmax(jnp.where(jnp.arange(_RING) >= start, lin_hs,
                                  -jnp.inf))
        pre = ((lin_ts[ai] + n // 4) % TIMESTAMP_MOD,   # SFD-gap fix (:371)
               lin_bin[ai],
               jnp.mean(mid_h))                          # stable h (:373-378)

        kind = jnp.where(count >= _PRE_MIN, _KIND_PRE,
                         jnp.where((count >= 2) & (count <= _DATA_MAX),
                                   _KIND_DATA, _KIND_BROKEN))
        is_pre = kind == _KIND_PRE
        return (kind,
                jnp.where(is_pre, pre[0], data[0]),
                jnp.where(is_pre, pre[1], data[1]),
                jnp.where(is_pre, pre[2], data[2]))

    # -- split-mode repeat-run extraction (models/pyramid.py
    # _split_repeat_track twin: per whole-symbol ts group, the best
    # recorded peak, snapped to exact one-symbol spacing from the
    # rising-edge apex with the bin rotated by the ts delta) -------------
    def split_extract(count, ring_ts, ring_bin, ring_h, ring_hs):
        idxs = (count - R + jnp.arange(R)) % R
        ts = ring_ts[idxs]
        bn = ring_bin[idxs]
        h = ring_h[idxs]
        hs = ring_hs[idxs]
        val = (count - R + jnp.arange(R)) >= 0
        hmax = jnp.max(jnp.where(val, h, -jnp.inf))
        ai = jnp.argmax(val & (h >= 0.95 * hmax))       # first plateau hit
        ats = ts[ai]
        rel = (ts - ats) % TIMESTAMP_MOD
        g = (rel + n // 2) // n                          # half-up
        use = val & (rel <= TIMESTAMP_MOD // 2) & (g < G)
        gm = (g[None, :] == jnp.arange(G)[:, None]) & use[None, :]
        hmask = jnp.where(gm, h[None, :], -jnp.inf)
        bi = jnp.argmax(hmask, axis=1)
        bh = jnp.max(hmask, axis=1)
        ok = gm.any(axis=1) & (bh >= 0.7 * hmax)
        snap = (ats + jnp.arange(G) * n) % TIMESTAMP_MOD
        dt = (snap - ts[bi] + n // 2) % TIMESTAMP_MOD - n // 2
        sbn = (bn[bi] + dt * k // n) % k
        return (snap, sbn, jnp.where(ok, h[bi], jnp.float32(0)),
                hs[bi], ok, ok.sum())

    # -- packet matching (add_symbol_to_packet :393-473) ------------------
    def pkt_step(st, x):
        kind, ts, bn, hh, ok = x
        is_pre = ok & (kind == _KIND_PRE)
        free = ~st["p_active"]
        any_f = free.any()
        fi = jnp.argmax(free)
        create = is_pre & any_f
        st["packets_dropped"] += (is_pre & ~any_f).astype(jnp.int32)
        st["p_active"] = _at_set(st["p_active"], fi, create, True)
        st["p_seq"] = _at_set(st["p_seq"], fi, create, st["pseq"])
        st["p_ttl"] = _at_set(st["p_ttl"], fi, create, _TTL0)
        st["p_pre_ts"] = _at_set(st["p_pre_ts"], fi, create, ts)
        st["p_pre_bin"] = _at_set(st["p_pre_bin"], fi, create, bn)
        st["p_pre_h"] = _at_set(st["p_pre_h"], fi, create, hh)
        st["p_count"] = _at_set(st["p_count"], fi, create, 0)
        st["pseq"] += create.astype(jnp.int32)

        is_data = ok & (kind == _KIND_DATA)
        tsd = (ts - st["p_pre_ts"]) % TIMESTAMP_MOD
        elig = st["p_active"] & (tsd > 4 * n) & (tsd < TIMESTAMP_MOD // 2)
        dt = (tsd % n).astype(jnp.float32) / n
        dt = jnp.where(dt > 0.5, (1 - dt) * 2, dt * 2)
        h_dis = jnp.abs(st["p_pre_h"] - hh) / st["p_pre_h"]
        elig &= h_dis < 0.5
        any_e = elig.any()
        m = jnp.min(jnp.where(elig, dt, jnp.inf))
        qi = jnp.argmin(jnp.where(elig & (dt == m), st["p_seq"], _IMAX))
        do = is_data & any_e
        cnt = st["p_count"][qi]
        room = cnt < S
        st["p_ttl"] = _at_set(st["p_ttl"], qi, do, _TTL0)
        cs = jnp.minimum(cnt, S - 1)
        st["p_ts"] = _at_set(st["p_ts"], (qi, cs), do & room, ts)
        st["p_bin"] = _at_set(st["p_bin"], (qi, cs), do & room, bn)
        st["p_h"] = _at_set(st["p_h"], (qi, cs), do & room, hh)
        st["p_count"] = _at_set(st["p_count"], qi, do,
                                jnp.minimum(cnt + 1, S))
        st["packet_peak_overflow"] += (do & ~room).astype(jnp.int32)
        return st, None

    # Split-mode packet step: each retired candidate contributes G+1
    # sequential entries.  ctl: 0 none; 1 preamble (normal); 2 data
    # (normal apex); 3 try-split — probe the first split peak as data,
    # on a miss fall back to creating the preamble (the host
    # _retire_track phase disambiguation), setting s_gate for the tail;
    # 4 gated tail (condA split peaks, live only if the probe matched);
    # 5 ungated tail (condB/C split peaks).
    def pkt_step_split(st, x):
        ctl, pts, pbin, phh, dts, dbin, dhh = x

        # Data-eligibility of the d-fields (same math as pkt_step).
        tsd = (dts - st["p_pre_ts"]) % TIMESTAMP_MOD
        elig = st["p_active"] & (tsd > 4 * n) & (tsd < TIMESTAMP_MOD // 2)
        dt = (tsd % n).astype(jnp.float32) / n
        dt = jnp.where(dt > 0.5, (1 - dt) * 2, dt * 2)
        h_dis = jnp.abs(st["p_pre_h"] - dhh) / st["p_pre_h"]
        elig &= h_dis < 0.5
        any_e = elig.any()
        m = jnp.min(jnp.where(elig, dt, jnp.inf))
        qi = jnp.argmin(jnp.where(elig & (dt == m), st["p_seq"], _IMAX))

        gate = st["s_gate"]
        create = (ctl == 1) | ((ctl == 3) & ~any_e)
        do_data = any_e & ((ctl == 2) | (ctl == 3)
                           | ((ctl == 4) & gate) | (ctl == 5))
        st["s_gate"] = jnp.where(ctl == 3, any_e, gate)

        free = ~st["p_active"]
        any_f = free.any()
        fi = jnp.argmax(free)
        cr = create & any_f
        st["packets_dropped"] += (create & ~any_f).astype(jnp.int32)
        st["p_active"] = _at_set(st["p_active"], fi, cr, True)
        st["p_seq"] = _at_set(st["p_seq"], fi, cr, st["pseq"])
        st["p_ttl"] = _at_set(st["p_ttl"], fi, cr, _TTL0)
        st["p_pre_ts"] = _at_set(st["p_pre_ts"], fi, cr, pts)
        st["p_pre_bin"] = _at_set(st["p_pre_bin"], fi, cr, pbin)
        st["p_pre_h"] = _at_set(st["p_pre_h"], fi, cr, phh)
        st["p_count"] = _at_set(st["p_count"], fi, cr, 0)
        st["pseq"] += cr.astype(jnp.int32)

        cnt = st["p_count"][qi]
        room = cnt < S
        st["p_ttl"] = _at_set(st["p_ttl"], qi, do_data, _TTL0)
        cs = jnp.minimum(cnt, S - 1)
        st["p_ts"] = _at_set(st["p_ts"], (qi, cs), do_data & room, dts)
        st["p_bin"] = _at_set(st["p_bin"], (qi, cs), do_data & room, dbin)
        st["p_h"] = _at_set(st["p_h"], (qi, cs), do_data & room, dhh)
        st["p_count"] = _at_set(st["p_count"], qi, do_data,
                                jnp.minimum(cnt + 1, S))
        st["packet_peak_overflow"] += (do_data & ~room).astype(jnp.int32)
        return st, None

    # -- assembly (general_work :610-767) ---------------------------------
    def assemble(pre_ts, pre_bin, pre_h, count, pts, pbin, ph):
        valid = jnp.arange(S) < count
        tsn = (pts - pre_ts) % TIMESTAMP_MOD
        key = jnp.where(valid, tsn, _IMAX)
        order = jnp.argsort(key, stable=True)
        sts = key[order]
        svalid = valid[order]
        sbin = pbin[order]
        sh = ph[order]

        lo = (lo0 + jnp.arange(W) * n)[:, None]          # [W, 1]
        inw = svalid[None, :] & (lo < sts[None, :]) & (sts[None, :] < lo + n)
        found = inw.any(axis=1)
        cont = (svalid[None, :] & (sts[None, :] >= lo + n)).any(axis=1)
        ok = found & cont
        # Window w runs iff every earlier window was found AND had peaks
        # beyond it (the reference's start_idx/end_idx walk termination).
        blocked = jnp.cumsum(~ok) - (~ok)       # earlier-failure count
        processed = blocked == 0

        # Best peak per window: min ts-phase+height distance, first in
        # sorted order (get_dis :187-196, selection :417-422).
        dtf = (sts % n).astype(jnp.float32) / n
        dtf = jnp.where(dtf > 0.5, (1 - dtf) * 2, dtf * 2)
        dis = dtf + jnp.abs(sh - pre_h) / pre_h
        bi = jnp.argmin(jnp.where(inw, dis[None, :], jnp.inf), axis=1)
        bts = sts[bi]
        shift = (bts % n) * k // n
        # Round, don't floor (deliberate deviation; see the Python twin
        # models/pyramid.py _assemble; quantize='floor' restores the
        # reference rule).
        sym = (((sbin[bi] - pre_bin - shift) % k + qoff) // ff) \
            % (k // ff)
        syms = jnp.where(processed & found, sym, 0).astype(jnp.int32)
        length = jnp.where(count == 0, 0, processed.sum())
        return syms, length, length >= 8                 # min payload (:755)

    # -- one hop ----------------------------------------------------------
    def hop_body(st, xs):
        st, _ = jax.lax.scan(peak_step, st, xs)

        # Retirement candidates: per-track peak cap first (in _add_peaks
        # order), then idle tracks (check_and_update_track :475-525).
        over = st["t_active"] & (st["t_count"] >= PYRAMID_MAX_TRACK_PEAKS)
        upd = st["t_updated"]
        graced = (st["t_misses"] < grace) & (st["t_count"] > _DATA_MAX)
        idle = st["t_active"] & ~over & ~upd & ~graced
        keep = st["t_active"] & ~over & ~idle

        n_over = over.sum()
        n_idle = idle.sum()
        io = jnp.argsort(jnp.where(over, st["t_seq"], _IMAX))
        ii = jnp.argsort(jnp.where(idle, st["t_seq"], _IMAX))
        fr = jnp.arange(F)
        cand = jnp.where(fr < n_over, io[jnp.minimum(fr, K - 1)],
                         ii[jnp.minimum(jnp.maximum(fr - n_over, 0), K - 1)])
        cand_ok = fr < jnp.minimum(n_over + n_idle, F)
        st["finalize_deferred"] += jnp.maximum(n_over + n_idle - F, 0)

        cc = jnp.clip(cand, 0, K - 1)
        cnts = st["t_count"][cc]
        kinds, ats, abin, ah = jax.vmap(classify)(
            cnts, st["t_ring_ts"][cc], st["t_ring_bin"][cc],
            st["t_ring_h"][cc], st["t_ring_hs"][cc], st["t_mid_h"][cc])
        add_ok = cand_ok & (kinds != _KIND_BROKEN)
        if split_repeats:
            sp_ts, sp_bin, sp_h, sp_hs, sp_ok, m_eff = jax.vmap(
                split_extract)(cnts, st["t_ring_ts"][cc],
                               st["t_ring_bin"][cc], st["t_ring_h"][cc],
                               st["t_ring_hs"][cc])

        proc = jnp.zeros(K + 1, bool).at[
            jnp.where(cand_ok, cand, K)].set(True)[:K]
        st["tracks_overflow_finalized"] += (proc & over).sum()
        st["t_active"] &= ~proc
        st["t_misses"] = jnp.where(keep & upd, 0,
                                   jnp.where(keep & ~upd,
                                             st["t_misses"] + 1,
                                             st["t_misses"]))
        st["t_updated"] = jnp.where(keep, False, st["t_updated"])

        if not split_repeats:
            st, _ = jax.lax.scan(pkt_step, st,
                                 (kinds, ats, abin, ah, add_ok))
        else:
            # models/pyramid.py _retire_track branch masks, in scan form.
            is_pre = kinds == _KIND_PRE
            is_data = kinds == _KIND_DATA
            is_brk = kinds == _KIND_BROKEN
            can_split = cand_ok & (m_eff >= 2)
            condA = can_split & is_pre & (cnts < R)
            condB = can_split & is_data & (cnts > _OV + 2) \
                & (cnts < _PRE_MIN)
            condC = can_split & is_brk & (cnts > _DATA_MAX) \
                & (cnts < _PRE_MIN)
            fvi = jnp.argmax(sp_ok, axis=1)
            arF = jnp.arange(F)
            ctl0 = jnp.where(condA, 3,
                             jnp.where(condB | condC, 0,
                                       jnp.where(add_ok & is_pre, 1,
                                                 jnp.where(add_ok & is_data,
                                                           2, 0))))
            tail_is_probe = jnp.arange(G)[None, :] == fvi[:, None]
            tail_ctl = jnp.where(
                ~sp_ok, 0,
                jnp.where(condA[:, None] & tail_is_probe, 0,
                          jnp.where(condA[:, None], 4,
                                    jnp.where((condB | condC)[:, None],
                                              5, 0))))
            ctl = jnp.concatenate([ctl0[:, None], tail_ctl], 1).reshape(-1)
            d0t = jnp.where(condA, sp_ts[arF, fvi], ats)
            d0b = jnp.where(condA, sp_bin[arF, fvi], abin)
            d0h = jnp.where(condA, sp_h[arF, fvi], ah)
            xs2 = (ctl,
                   jnp.broadcast_to(ats[:, None], (F, G + 1)).reshape(-1),
                   jnp.broadcast_to(abin[:, None], (F, G + 1)).reshape(-1),
                   jnp.broadcast_to(ah[:, None], (F, G + 1)).reshape(-1),
                   jnp.concatenate([d0t[:, None], sp_ts], 1).reshape(-1),
                   jnp.concatenate([d0b[:, None], sp_bin], 1).reshape(-1),
                   jnp.concatenate([d0h[:, None], sp_h], 1).reshape(-1))
            st, _ = jax.lax.scan(pkt_step_split, st, xs2)

        # TTL expiry + assembly (:610-767).
        exp = st["p_active"] & (st["p_ttl"] <= 0)
        n_exp = exp.sum()
        eorder = jnp.argsort(jnp.where(exp, st["p_seq"], _IMAX))[:E]
        e_ok = jnp.arange(E) < jnp.minimum(n_exp, E)
        st["expire_deferred"] += jnp.maximum(n_exp - E, 0)
        ec = jnp.clip(eorder, 0, Q - 1)
        syms, lens, emits = jax.vmap(assemble)(
            st["p_pre_ts"][ec], st["p_pre_bin"][ec], st["p_pre_h"][ec],
            st["p_count"][ec], st["p_ts"][ec], st["p_bin"][ec],
            st["p_h"][ec])
        emits &= e_ok
        rank = jnp.cumsum(emits) - emits.astype(jnp.int32)
        slot = st["o_count"] + rank
        put = emits & (slot < O)
        st["out_overflow"] += (emits & (slot >= O)).sum()
        tgt = jnp.where(put, slot, O)
        st["o_syms"] = st["o_syms"].at[tgt].set(syms, mode="drop")
        st["o_len"] = st["o_len"].at[tgt].set(lens, mode="drop")
        st["o_pos"] = st["o_pos"].at[tgt].set(st["p_pre_ts"][ec],
                                              mode="drop")
        st["o_count"] = jnp.minimum(st["o_count"] + emits.sum(), O)
        st["p_active"] = st["p_active"].at[
            jnp.where(e_ok, eorder, Q)].set(False, mode="drop")
        st["p_ttl"] = jnp.where(st["p_active"] & (st["p_ttl"] > 0),
                                st["p_ttl"] - 1, st["p_ttl"])

        st["ts_ref"] = (st["ts_ref"] + hop) % TIMESTAMP_MOD
        st["bin_ref"] = (st["bin_ref"] + k // _OV) % k
        return st, None

    def process(state, bins, h, hs, valid):
        """Consume a [H, max_peaks] lattice block (ascending-bin order is
        established here, matching the reference's bin scan :227)."""
        key = jnp.where(valid, bins, i32(k + 1))
        order = jnp.argsort(key, axis=-1, stable=True)
        tk = partial(jnp.take_along_axis, axis=-1)
        xs = (tk(bins, order), tk(h, order), tk(hs, order),
              tk(valid, order))
        state, _ = jax.lax.scan(hop_body, state, xs)
        return state

    return init_state, process


_DEVIATION_COUNTERS = ("tracks_dropped", "packets_dropped",
                       "finalize_deferred", "expire_deferred",
                       "packet_peak_overflow", "out_overflow")


def make_channel_tracker_plan(cfg: LoraConfig, block_hops: int,
                              max_peaks: int = 16, grace: int = 0,
                              backend: str = "xla", mesh=None,
                              lattice_block_hops: int | None = None,
                              **pools):
    """Fused lattice+tracker step over a channel batch — the gateway's
    on-device tracking mode (dist/pyramid_gateway.py ``tracker='device'``).

    Returns ``(init, step, pop)``:

    - ``init(channels)`` -> per-channel tracker states (leading C axis;
      with a mesh, placed ``P('ch')`` and replicated along ``t``).
    - ``step(states, iq[, tail])`` -> ``(states', o_count[C])``: computes
      the peak lattice for one ``[C, block_len(+halo), 2]`` IQ block and
      advances every channel's tracker ON DEVICE — the lattice is consumed
      where it is produced; only the int32 packet counter ever needs to
      sync.  With a mesh the IQ is ``P('ch','t')`` with a ppermute'd
      right halo exactly like the host-tracker plan, and the per-t-shard
      lattices are ``all_gather``ed along ``t`` (peaks are ~KB — the
      gather rides ICI) so the tracker scan, which is sequential in time,
      runs replicated on every t-shard of its channel row.
    - ``pop(states)`` -> ``(states', (o_len, o_pos, o_syms))``: takes the
      finished packets and zeroes the output pool — called only when
      ``o_count`` says there is something to fetch.
    """
    from .pyramid import peak_lattice_fn

    init1, proc = make_device_tracker(cfg, max_peaks, grace, **pools)
    n = cfg.num_samples
    hop = n // _OV
    halo = n - hop

    def pop(states):
        # o_count here is authoritative: the step's returned counts are a
        # pipelined *hint* (snapshotted one block earlier), so a pop racing
        # a newer step must take exactly what is in the pool now.
        outs = (states["o_count"], states["o_len"], states["o_pos"],
                states["o_syms"])
        states = dict(states)
        states["o_count"] = jnp.zeros_like(states["o_count"])
        return states, outs

    if mesh is None:
        lat = peak_lattice_fn(cfg, block_hops, max_peaks, backend,
                              block_hops=lattice_block_hops)

        def one(state, x):
            return proc(state, *lat(x))

        def step(states, iq):
            states = jax.vmap(one)(states, iq)
            return states, states["o_count"]

        def init(channels):
            return jax.vmap(lambda _: init1())(jnp.arange(channels))

        return (init, jax.jit(step, donate_argnums=0),
                jax.jit(pop, donate_argnums=0))

    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    nt = mesh.shape.get("t", 1)
    if block_hops % nt:
        raise ValueError(f"block_hops {block_hops} % t-shards {nt} != 0")
    lat = peak_lattice_fn(cfg, block_hops // nt, max_peaks, backend,
                          block_hops=lattice_block_hops)

    def shard_body(states_local, iq_local, tail_local):
        right = jax.lax.ppermute(
            iq_local[:, :halo, :], "t",
            [(i + 1, i) for i in range(nt - 1)])
        is_last = jax.lax.axis_index("t") == nt - 1
        right = jnp.where(is_last, tail_local, right)
        ext = jnp.concatenate([iq_local, right], axis=1)
        outs = jax.vmap(lat)(ext)          # [C/nch, H/nt, M] each
        full = tuple(jax.lax.all_gather(o, "t", axis=1, tiled=True)
                     for o in outs)        # [C/nch, H, M] — replicated walk
        states_local = jax.vmap(proc)(states_local, *full)
        # Counter hint replicated over 'ch' too: in multi-host every
        # process must take the SAME pop decision (SPMD discipline), so
        # each needs the GLOBAL counts, and they are 4 B/channel.
        counts = jax.lax.all_gather(states_local["o_count"], "ch",
                                    axis=0, tiled=True)
        return states_local, counts

    st_spec = lambda leaf: P(*(("ch",) + (None,) * (leaf.ndim - 1)))

    def _state_specs(states):
        return jax.tree.map(st_spec, states)

    def init(channels):
        def build():
            return jax.vmap(lambda _: init1())(jnp.arange(channels))

        shardings = jax.tree.map(
            lambda l: NamedSharding(mesh, st_spec(l)),
            jax.eval_shape(build))
        # jit-with-out_shardings creation is multi-controller safe (a
        # host-built array could not be device_put across processes).
        return jax.jit(build, out_shardings=shardings)()

    proto = jax.eval_shape(lambda: jax.vmap(lambda _: init1())(
        jnp.arange(mesh.shape.get("ch", 1))))
    sspec = _state_specs(proto)
    out_proto = jax.eval_shape(pop, proto)[1]
    ospec = jax.tree.map(st_spec, out_proto)
    # States are replicated along 't' by construction (every t-shard walks
    # the all_gathered lattice identically); the halo ppermute defeats
    # shard_map's static replication check, so it is disabled.
    shmap = partial(jax.shard_map, check_vma=False)
    inner = shmap(
        shard_body, mesh=mesh,
        in_specs=(sspec, P("ch", "t", None), P("ch", None, None)),
        out_specs=(sspec, P()),
    )
    pop_sharded = shmap(pop, mesh=mesh, in_specs=(sspec,),
                        out_specs=(sspec, ospec))
    return (init, jax.jit(inner, donate_argnums=0),
            jax.jit(pop_sharded, donate_argnums=0))


class DevicePyramidTracker:
    """Host handle over one on-device tracker: feed lattice blocks (device
    arrays — nothing is fetched), drain finished packets (the only
    device->host transfer: O(packets) bytes).

    Drop-in for PyramidTracker at the block level; ``flush()`` retires all
    live state exactly like host flush_hops empty steps.
    """

    def __init__(self, cfg: LoraConfig, max_peaks: int = 16, grace: int = 0,
                 **pools):
        self.cfg = cfg
        self.grace = grace
        init, proc = make_device_tracker(cfg, max_peaks, grace, **pools)
        self.state = init()
        self._proc = jax.jit(proc)
        self._max_peaks = max_peaks

    def feed(self, bins, h, hs, valid):
        self.state = self._proc(self.state, bins, h, hs, valid)

    def feed_empty(self, num_hops: int):
        m = self._max_peaks
        z = jnp.zeros((num_hops, m), jnp.int32)
        self.feed(z, z.astype(jnp.float32), z.astype(jnp.float32),
                  z.astype(bool))

    def flush_hops(self) -> int:
        return flush_hops(self.grace)

    def drain(self):
        """Fetch finished packets; returns (symbol arrays, positions)."""
        got = jax.device_get({k: self.state[k] for k in
                              ("o_count", "o_len", "o_pos", "o_syms")})
        cnt = int(got["o_count"])
        syms = [got["o_syms"][i, :got["o_len"][i]].astype(np.uint16)
                for i in range(cnt)]
        pos = [int(p) for p in got["o_pos"][:cnt]]
        if cnt:
            self.state = dict(self.state)
            self.state["o_count"] = jnp.int32(0)
        return syms, pos

    def stats(self) -> dict:
        got = jax.device_get({k: self.state[k] for k in
                              _DEVIATION_COUNTERS
                              + ("tracks_overflow_finalized",)})
        return {k: int(v) for k, v in got.items()}

    def deviations(self) -> int:
        """Total bounded-pool deviation events (0 = host-exact semantics)."""
        s = self.stats()
        return sum(s[k] for k in _DEVIATION_COUNTERS)
