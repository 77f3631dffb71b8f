"""Wideband channelizer: one SDR stream -> a bank of LoRa channels.

The reference processes a single 125 kHz channel and lists multi-channel
decoding as future work (reference README.md:45).  A gateway ingests
one wideband capture (e.g. 8 Msps = 64 x 125 kHz) and must split it into
per-channel baseband streams at the demod rate p*bw.  Expressed as
matmuls: output sample m of channel c is

    y[m, c] = phase(m, c) * dot(x[m*D : m*D + W], h .* carrier_c)

i.e. one strided-frame gather plus ONE packed complex matmul against a
[W, C] filter-times-carrier matrix, with the residual per-(m, c) phase a
cheap elementwise factor.  Decimation D = fs_in / (p * spacing) gives
output directly at the demod rate (oversampled-by-p channelizer), so the
result feeds dist.gateway / MultiSFReceiver unchanged.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.cplx import cmatmul_packed, pack_cmatmul_weights

@lru_cache(maxsize=None)
def _channelizer_plan(num_channels: int, decim: int, taps_per_phase: int,
                      spacing_ratio: float):
    """Precompute the packed [2W, 2C] filter-carrier matrix.

    spacing_ratio = channel spacing / fs_in (= 1 / num_channels for a
    critically-stacked bank).
    """
    # Windowed sinc designed AT the bank length: LoRa needs >50 dB
    # adjacent-stream rejection (it decodes below -12 dB SNR), so never
    # truncate a longer design — that wrecks the stopband.
    w = taps_per_phase * num_channels | 1
    m = (w - 1) // 2
    ns0 = np.arange(-m, m + 1)
    cutoff = 0.5 * spacing_ratio
    proto = np.sinc(2 * cutoff * ns0) * (2 * cutoff) * np.kaiser(w, 10.0)
    proto = (proto / proto.sum()).astype(np.float32)
    # Channel c sits at frequency offset (c - C/2) * spacing (centered grid).
    offs = (np.arange(num_channels) - num_channels // 2) * spacing_ratio
    ns = np.arange(w)
    carrier = np.exp(-2j * np.pi * np.outer(ns, offs))       # [W, C]
    wc = proto[:, None] * carrier
    packed = pack_cmatmul_weights(wc.real.astype(np.float32),
                                  wc.imag.astype(np.float32))
    return packed, w, offs


def channelize(iq: jnp.ndarray, num_channels: int, fs_in: float,
               spacing: float = 125e3, p: int = 2,
               taps_per_phase: int = 16,
               sample_offset: int = 0) -> jnp.ndarray:
    """[T, 2] wideband IQ at fs_in -> [C, T_out, 2] per-channel baseband at
    p * spacing (ready for the demodulators).

    fs_in must be an integer multiple of p * spacing.  ``sample_offset`` is
    the absolute input-sample index of ``iq[0]`` — it keeps the residual
    carrier phase continuous when a long stream is channelized in blocks
    (StreamingChannelizer passes it).
    """
    out_rate = p * spacing
    decim_f = fs_in / out_rate
    decim = int(round(decim_f))
    if abs(decim - decim_f) > 1e-9:
        raise ValueError(f"fs_in {fs_in} not an integer multiple of {out_rate}")
    packed, w, offs = _channelizer_plan(
        num_channels, decim, taps_per_phase, spacing / fs_in)

    t = iq.shape[0]
    m = max((t - w) // decim + 1, 0)
    # Strided frames via static slices on a chunked view (no gather).
    nchunks = (m - 1) + -(-w // decim)
    usable = nchunks * decim
    pad = max(usable - t, 0)
    x = jnp.pad(iq.astype(jnp.float32), ((0, pad), (0, 0)))[:usable]
    chunks = x.reshape(nchunks, decim, 2)
    r = -(-w // decim)
    frames = jnp.concatenate(
        [jax.lax.slice_in_dim(chunks, k, k + m, axis=0) for k in range(r)],
        axis=1,
    ).reshape(m, r * decim, 2)[:, :w, :]

    y = cmatmul_packed(frames, jnp.asarray(packed))          # [M, C, 2]

    # Residual carrier phase at the frame starts: e^{-2pi i f_c m D}.
    md = np.arange(m)[:, None] * decim + sample_offset
    ang = -2 * np.pi * (md * offs[None, :])
    rot = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    yr = y[..., 0] * rot[..., 0] - y[..., 1] * rot[..., 1]
    yi = y[..., 0] * rot[..., 1] + y[..., 1] * rot[..., 0]
    return jnp.stack([yr, yi], axis=-1).transpose(1, 0, 2)   # [C, M, 2]


def channel_frequencies(num_channels: int, spacing: float = 125e3
                        ) -> np.ndarray:
    """Baseband center frequency of each output channel."""
    return (np.arange(num_channels) - num_channels // 2) * spacing


class StreamingChannelizer:
    """``channelize`` over an unbounded stream, fed in arbitrary blocks.

    Carries the polyphase filter history (w - decim samples) across block
    seams and the absolute sample index for residual-carrier phase
    continuity, so the concatenated per-channel outputs are bit-identical
    to one whole-capture ``channelize`` call (tests/test_channelizer.py).
    """

    def __init__(self, num_channels: int, fs_in: float,
                 spacing: float = 125e3, p: int = 2,
                 taps_per_phase: int = 16):
        out_rate = p * spacing
        decim_f = fs_in / out_rate
        self.decim = int(round(decim_f))
        if abs(self.decim - decim_f) > 1e-9:
            raise ValueError(
                f"fs_in {fs_in} not an integer multiple of {out_rate}")
        self.num_channels = num_channels
        self.fs_in = fs_in
        self.spacing = spacing
        self.p = p
        self.taps_per_phase = taps_per_phase
        self.w = taps_per_phase * num_channels | 1
        self._hist = np.zeros((0, 2), np.float32)
        self._abs = 0            # absolute input-sample index of _hist[0]
        #: absolute OUTPUT-sample index of the next emitted sample
        self.out_pos = 0

    def feed(self, iq_ri: np.ndarray) -> np.ndarray:
        """[T, 2] float32 (or [T] complex) -> [C, M, 2] numpy; M may be 0
        while the filter history fills."""
        if np.iscomplexobj(iq_ri):
            iq_ri = np.stack([iq_ri.real, iq_ri.imag], -1)
        x = np.concatenate([self._hist,
                            np.asarray(iq_ri, np.float32)], axis=0)
        t = x.shape[0]
        m = (t - self.w) // self.decim + 1
        if m <= 0:
            self._hist = x
            return np.zeros((self.num_channels, 0, 2), np.float32)
        import jax

        y = np.asarray(jax.device_get(channelize(
            jnp.asarray(x), self.num_channels, self.fs_in, self.spacing,
            p=self.p, taps_per_phase=self.taps_per_phase,
            sample_offset=self._abs)))
        consumed = m * self.decim
        self._hist = x[consumed:]
        self._abs += consumed
        self.out_pos += m
        return np.ascontiguousarray(y)

    def flush(self) -> np.ndarray:
        """Zero-pad the history through the filter; final partial output."""
        pad = np.zeros((self.w, 2), np.float32)
        return self.feed(pad)
