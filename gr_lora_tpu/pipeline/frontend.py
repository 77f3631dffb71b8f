"""RX front-end: low-pass FIR + polyphase arbitrary resampler + replay.

Equivalent of the stock GNU Radio chain every reference RX flowgraph wires
before the demodulators (examples/rx_file.grc: low_pass_filter with cutoff
bw/2+10 kHz, width 1 kHz, then pfb_arb_resampler with rrate = 2*bw/samp_rate,
nfilts=32, atten=100) — re-built as jit-able array ops:

- the FIR is a single real-taps convolution over the (re, im) pair, which
  XLA lowers to convolutions;
- the arbitrary resampler evaluates all output samples at once: one gather
  of input windows + one per-output-phase dot with the polyphase bank, with
  linear interpolation between adjacent phases (the same two-filter
  interpolation gr::filter::pfb_arb_resampler performs).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LoraConfig


# ---------------------------------------------------------------------------
# Filter design (host, numpy) — gr::filter::firdes equivalents.
# ---------------------------------------------------------------------------

def _window(kind: str, ntaps: int, beta: float = 6.76) -> np.ndarray:
    kind = kind.lower()
    if kind in ("rect", "rectangular"):
        return np.ones(ntaps)
    if kind == "hamming":
        return np.hamming(ntaps)
    if kind == "hann":
        return np.hanning(ntaps)
    if kind == "blackman":
        return np.blackman(ntaps)
    if kind == "kaiser":
        return np.kaiser(ntaps, beta)
    raise ValueError(f"unknown window {kind!r}")


def design_low_pass(gain: float, fs: float, cutoff: float, transition: float,
                    window: str = "hamming", beta: float = 6.76) -> np.ndarray:
    """firdes.low_pass: windowed-sinc taps, odd length from the transition
    width heuristic (gain at DC normalized)."""
    # GR heuristic: ntaps = 3.3 / (transition/fs) for hamming-class windows.
    ntaps = int(3.3 * fs / transition)
    ntaps |= 1  # odd
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1)
    taps = np.sinc(2 * cutoff / fs * n) * (2 * cutoff / fs)
    taps *= _window(window, ntaps, beta)
    return (gain * taps / taps.sum()).astype(np.float32)


def design_pfb_prototype(nfilts: int, rrate: float, atten: float = 100.0
                         ) -> np.ndarray:
    """Prototype low-pass for the polyphase arbitrary resampler
    (gr pfb_arb_resampler default: kaiser low-pass at the minimum of the
    input/output Nyquist rates, designed at nfilts x input rate)."""
    beta = 0.1102 * (atten - 8.7) if atten > 50 else (
        0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21) if atten >= 21
        else 0.0)
    cutoff = 0.5 * min(1.0, rrate)            # in input-rate units
    ntaps_per_branch = int(np.ceil((atten - 7.95) / (2.285 * 2 * np.pi
                                                     * 0.1 * cutoff)))
    ntaps = nfilts * max(ntaps_per_branch, 8)
    ntaps |= 1
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1)
    taps = np.sinc(cutoff / nfilts * n * 2) * (cutoff / nfilts * 2)
    taps *= np.kaiser(ntaps, beta)
    taps *= nfilts / taps.sum()
    return taps.astype(np.float32)


# ---------------------------------------------------------------------------
# Jit-able stages.
# ---------------------------------------------------------------------------

def fir_filter(iq: jnp.ndarray, taps: np.ndarray) -> jnp.ndarray:
    """[T, 2] x real taps -> [T, 2] ('same' alignment; the demod FSM
    re-synchronizes, so group delay only shifts detection positions)."""
    t = jnp.asarray(taps, jnp.float32)
    x = jnp.moveaxis(iq, -1, 0)[:, None, :]          # [2, 1, T]
    w = t[None, None, ::-1]                          # [1, 1, ntaps]
    pad = (len(taps) - 1) // 2
    y = jax.lax.conv_general_dilated(
        x, w, window_strides=(1,), padding=[(pad, len(taps) - 1 - pad)])
    return jnp.moveaxis(y[:, 0, :], 0, -1)


@lru_cache(maxsize=None)
def _pfb_bank(nfilts: int, rrate_q: float, atten: float):
    proto = design_pfb_prototype(nfilts, rrate_q, atten)
    per = int(np.ceil(len(proto) / nfilts))
    padded = np.zeros(per * nfilts, np.float32)
    padded[: len(proto)] = proto
    # branch j handles phase j/nfilts: taps_j[i] = proto[i*nfilts + j]
    bank = padded.reshape(per, nfilts).T             # [nfilts, per]
    return bank, per


def polyphase_resample(iq: jnp.ndarray, rrate: float, nfilts: int = 32,
                       atten: float = 100.0) -> jnp.ndarray:
    """Arbitrary-rate polyphase resampler, [T, 2] -> [round(T*rrate), 2].

    Output k is taken at input time k/rrate: window dot branch(phase), with
    linear interpolation between the two adjacent phase branches.
    """
    bank, per = _pfb_bank(nfilts, float(round(rrate, 9)), atten)
    t_in = iq.shape[0]
    n_out = int(np.floor(t_in * rrate))
    k = np.arange(n_out)
    pos = k / rrate
    base = np.floor(pos).astype(np.int64)
    frac = pos - base
    phase = frac * nfilts
    j0 = np.floor(phase).astype(np.int64)
    alpha = (phase - j0).astype(np.float32)
    j1 = (j0 + 1) % nfilts
    carry = ((j0 + 1) // nfilts).astype(np.int64)    # j1 wrap advances base

    pad = per
    iqp = jnp.pad(iq, ((pad, pad + 1), (0, 0)))
    # Window for output k: samples base+pad-per+1 .. base+pad (causal taps).
    win_idx = (base[:, None] + pad - per + 1 + np.arange(per)[None, :])
    w0 = iqp[win_idx]                                 # [n_out, per, 2]
    w1 = iqp[win_idx + carry[:, None]]
    b = jnp.asarray(bank[:, ::-1])                    # time-reversed taps
    t0 = b[j0]                                        # [n_out, per]
    t1 = b[j1]
    y0 = jnp.einsum("kp,kpc->kc", t0, w0)
    y1 = jnp.einsum("kp,kpc->kc", t1, w1)
    return y0 * (1 - alpha[:, None]) + y1 * alpha[:, None]


def resample_to_receiver_rate(iq: jnp.ndarray, fs: float, cfg: LoraConfig,
                              bw: float = 125e3, nfilts: int = 32
                              ) -> jnp.ndarray:
    """Capture rate fs -> demod rate p*bw (reference rrate = 2*bw/samp_rate)."""
    return polyphase_resample(iq, cfg.p * bw / fs, nfilts=nfilts)


# ---------------------------------------------------------------------------
# Replay: full RX chain over a capture.
# ---------------------------------------------------------------------------

def replay(iq, fs: float, cfg: LoraConfig, bw: float = 125e3,
           mode: str = "plain", max_packets: int = 8):
    """Capture at rate fs -> [LPF -> resample -> demod -> decode] results.

    Mirror of examples/rx_file.grc (mode='plain') and
    examples/rx_file_collision.grc (mode='pyramid').
    Returns list of (symbols, DecodeResult).
    """
    from ..core.codec import decode
    from ..models.demodulator import demodulate
    from ..models.pyramid import pyramid_demodulate
    from ..ops.cplx import to_ri

    if np.iscomplexobj(iq):
        iq = to_ri(np.asarray(iq))
    iq = jnp.asarray(np.asarray(iq, np.float32))

    taps = design_low_pass(1.0, fs, bw / 2 + 10e3, 1e3, window="hamming")
    filtered = fir_filter(iq, taps)
    resampled = np.asarray(jax.device_get(
        resample_to_receiver_rate(filtered, fs, cfg, bw)))

    if mode == "plain":
        pkts = demodulate(resampled, cfg, max_packets=max_packets)
    elif mode == "pyramid":
        pkts = pyramid_demodulate(resampled, cfg)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return [(syms, decode(syms, cfg)) for syms in pkts]


def upsample_to_capture_rate(iq, p_tx: int, fs: float, cfg: LoraConfig,
                             bw: float = 125e3) -> np.ndarray:
    """TX helper: modulator output at p_tx samples/chip -> capture rate fs
    (the tx_usrp.grc interpolating-resampler step); used to fabricate
    realistic file captures for replay tests."""
    from ..ops.cplx import from_ri, to_ri

    if np.iscomplexobj(iq):
        iq = to_ri(np.asarray(iq))
    rrate = fs / (p_tx * bw)
    out = polyphase_resample(jnp.asarray(np.asarray(iq, np.float32)), rrate)
    return from_ri(np.asarray(jax.device_get(out)))
