"""Dechirp + zoom-DFT + folded peak search — the RX hot path.

Shape-static jnp shared by the plain, pyramid and weak demodulators
(reference hot loops: demod_impl.cc:329-359/162-213,
pyramid_demod_impl.cc:569-603, weak_demod_impl.cc:146-194).  The dechirp
multiply, optional Kaiser window, zero-padded FFT and band selection are all
fused into real matmuls by ZoomDftPlan (see ops/dft.py).

Folding conventions (careful — this is a reference landmine, SURVEY.md §7):

- demod & weak fold mags[:K] + mags[F-K:] (demod_impl.cc:176,
  weak_demod_impl.cc:164) — the physically right fold: the "ghost" splice
  tone of a window straddling two chirps sits at negative frequencies,
  i.e. the top K bins.
- pyramid folds mags[:K] + mags[K:2K] (pyramid_demod_impl.cc:596,603).
  At the reference's validated operating point fs/bw = 2 the spectrum has
  F = 2K bins, so [K, 2K) IS the top band and the fold is correct.  At
  fs/bw > 2 (the GRC default is 8, lora_pyramid_demod.block.yml:31)
  [K, 2K) covers frequencies (+bw, +2bw) that a dechirped tone can never
  occupy, the ghost lands unfolded in [F-K, F), windowed peaks vanish for
  the tail hops of every straddled symbol, and preamble tracks fragment
  below the classification length — the reference's own pyramid cannot
  work at its advertised default ratio.  We therefore fold
  mags[:K] + mags[F-K:] for ALL p: bit-identical to the reference at
  p = 2, and actually functional at p = 8 (tests/test_envelope_corners).
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..config import LoraConfig, PeakSearch
from .chirp import chirp_tables
from .cplx import cmag
from .dft import BandSpec, ZoomDftPlan


@lru_cache(maxsize=None)
def kaiser_window(num_samples: int, beta: float) -> np.ndarray:
    """Kaiser window as built by gr::fft::window::build(WIN_KAISER, n, beta)
    (reference: demod_impl.cc:121, pyramid_demod_impl.cc:98)."""
    return np.kaiser(num_samples, beta).astype(np.float32)


@lru_cache(maxsize=None)
def _up_plan(sf: int, p: int, fft_factor: int,
             precision: str = "highest") -> ZoomDftPlan:
    """Plan dechirping data/preamble upchirps: multiply by the +phi chirp
    (the reference's 'downchirp' table, demod_impl.cc:329)."""
    _, down = chirp_tables(sf, p)
    n = p << sf
    return ZoomDftPlan(n, fft_factor * n,
                       BandSpec(fft_factor << sf, fft_factor << sf), down,
                       precision=precision)


@lru_cache(maxsize=None)
def _down_plan(sf: int, p: int, fft_factor: int,
               precision: str = "highest") -> ZoomDftPlan:
    """Plan dechirping the SFD downchirps: multiply by the -phi chirp."""
    up, _ = chirp_tables(sf, p)
    n = p << sf
    return ZoomDftPlan(n, fft_factor * n,
                       BandSpec(fft_factor << sf, fft_factor << sf), up,
                       precision=precision)


@lru_cache(maxsize=None)
def _pyramid_plan(sf: int, p: int, fft_factor: int, beta: float,
                  precision: str = "highest") -> ZoomDftPlan:
    """Pyramid needs bins [0, K) + top K, both unwindowed and
    Kaiser-windowed — fused as two variants of ONE packed matmul."""
    _, down = chirp_tables(sf, p)
    n = p << sf
    k = fft_factor << sf
    assert 2 * k <= fft_factor * n, "pyramid fold requires p >= 2 (reference uses 8)"
    import numpy as _np
    mods = _np.stack([down, down * kaiser_window(n, beta)])
    return ZoomDftPlan(n, fft_factor * n, BandSpec(k, k), mods,
                       precision=precision)


def band_peak(lo: jnp.ndarray, hi: jnp.ndarray, cfg: LoraConfig):
    """(lo, hi) complex bands [..., K, 2] -> (argmax int32, max_val) using
    cfg.peak_search (reference: demod_impl.cc:162-213)."""
    if cfg.peak_search == PeakSearch.ABS:
        folded = cmag(lo) + cmag(hi)
        idx = jnp.argmax(folded, axis=-1)
        val = jnp.take_along_axis(folded, idx[..., None], axis=-1)[..., 0]
        return idx.astype(jnp.int32), val
    k = cfg.peak_phase_k if cfg.peak_search == PeakSearch.PHASE else 1
    th = 2.0 * np.pi / k * np.arange(k)
    rot = jnp.asarray(np.stack([np.cos(th), np.sin(th)], -1).astype(np.float32))  # [k, 2]
    lr, li = lo[..., None, :, 0], lo[..., None, :, 1]
    rr, ri = rot[:, None, 0], rot[:, None, 1]
    sr = lr * rr - li * ri + hi[..., None, :, 0]
    si = lr * ri + li * rr + hi[..., None, :, 1]
    mags = jnp.sqrt(sr * sr + si * si)                    # [..., k, K]
    flat = mags.reshape(*mags.shape[:-2], -1)
    best = jnp.argmax(flat, axis=-1)
    val = jnp.take_along_axis(flat, best[..., None], axis=-1)[..., 0]
    return (best % lo.shape[-2]).astype(jnp.int32), val


def up_peak(window: jnp.ndarray, cfg: LoraConfig):
    """Window(s) [..., N, 2] -> folded up-chirp peak (idx, val)."""
    lo, hi = _up_plan(cfg.sf, cfg.p, cfg.fft_factor, cfg.precision)(window)
    return band_peak(lo, hi, cfg)


def up_peak_stats(window: jnp.ndarray, cfg: LoraConfig):
    """(peak, mean) of the ABS-folded up-chirp spectrum — the noise-floor
    proxy behind per-packet SNR estimates (beyond-reference; the reference
    reports no signal quality).  Always the ABS fold regardless of
    cfg.peak_search: the estimate is calibrated for it
    (models.demodulator.snr_db_estimate)."""
    lo, hi = _up_plan(cfg.sf, cfg.p, cfg.fft_factor, cfg.precision)(window)
    folded = cmag(lo) + cmag(hi)
    return jnp.max(folded, axis=-1), jnp.mean(folded, axis=-1)


def down_peak(window: jnp.ndarray, cfg: LoraConfig):
    """Window(s) [..., N, 2] -> folded down-chirp (SFD) peak (idx, val)."""
    lo, hi = _down_plan(cfg.sf, cfg.p, cfg.fft_factor, cfg.precision)(window)
    return band_peak(lo, hi, cfg)


def up_bands(window: jnp.ndarray, cfg: LoraConfig):
    """Raw folded bands for consumers that combine magnitudes themselves
    (weak demod's non-coherent two-symbol sum, weak_demod_impl.cc:192)."""
    return _up_plan(cfg.sf, cfg.p, cfg.fft_factor, cfg.precision)(window)


def down_bands(window: jnp.ndarray, cfg: LoraConfig):
    return _down_plan(cfg.sf, cfg.p, cfg.fft_factor, cfg.precision)(window)


def frame_signal(iq: jnp.ndarray, frame_len: int, hop: int, num_frames: int,
                 start: int = 0) -> jnp.ndarray:
    """Strided frames [num_frames, frame_len, 2] of an IQ stream [T, 2]."""
    idx = start + jnp.arange(num_frames)[:, None] * hop + jnp.arange(frame_len)[None, :]
    return iq[idx]


def pyramid_spectra(frames: jnp.ndarray, cfg: LoraConfig):
    """Per-hop dense spectra for the pyramid demod, batched over frames.

    frames [B, N, 2] -> (fft_add, fft_add_w, h_single), each [B, K]:
    - fft_add:   unwindowed, mags[:K] + mags[F-K:]
      (== pyramid_demod_impl.cc:596's [K, 2K) fold at p = 2; the top-band
      fold generalizes it correctly to p > 2 — see module docstring)
    - fft_add_w: Kaiser-windowed, same fold          (pyramid_demod_impl.cc:603)
    - h_single:  max(mags[:K], mags[F-K:])           (pyramid_demod_impl.cc:269)
    """
    plan = _pyramid_plan(cfg.sf, cfg.p, cfg.fft_factor, cfg.beta,
                         cfg.precision)
    (lo, hi), (lo_w, hi_w) = plan(frames)
    mlo, mhi = cmag(lo), cmag(hi)
    fft_add = mlo + mhi
    h_single = jnp.maximum(mlo, mhi)
    fft_add_w = cmag(lo_w) + cmag(hi_w)
    return fft_add, fft_add_w, h_single
