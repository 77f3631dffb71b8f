"""Zoom DFT of dechirped frames as matmuls.

The receivers need only two narrow bands of the zero-padded FFT of each
dechirped symbol window: bins [0, nlo) and [F-nhi, F) of the F-point spectrum
(F = fft_factor * p * 2^sf), because a dechirped LoRa symbol is a tone inside
+-bw (reference folding: demod_impl.cc:176, pyramid_demod_impl.cc:596).
Complex values are float32 (re, im) pairs (ops/cplx.py), and those bands
are computed directly as real matmuls, which the GPU runs on its tensor
cores (whether an FFT plus a band slice is faster there is open,
ROADMAP.md):

- **direct**: one [N, nlo+nhi] complex matrix W[n,k] = v[n] * exp(-2pi*i*n*k/F)
  with the dechirp (and optional window) vector v folded in — dechirp, window,
  zero-padded FFT and band selection fuse into a single complex matmul
  (4 real matmuls).

- **four-step**: for large N the direct matrix is too big, so use the padded-
  FFT identity X[factor*m + r] = FFT_N(x * tw_r)[m] with tw_r[n] =
  exp(-2pi*i*r*n/F), and evaluate each FFT_N with the four-step Cooley-Tukey
  factorization N = N1*N2 — two small DFT matmuls plus a twiddle, all
  matmul-shaped.

Both paths operate on float32 (re, im) pairs; see ops/cplx.py.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .cplx import cmatmul, cmatmul_packed, cmul, pack_cmatmul_weights

# Matrices larger than this (complex elements) switch to the four-step path.
_DIRECT_MAX_ELEMS = 1 << 23  # 8M complex = 64 MB as two f32 matrices


def _resolve_precision(name: str):
    """(lax precision, compute dtype) for a LoraConfig.precision string."""
    if name == "highest":
        return jax.lax.Precision.HIGHEST, None
    if name == "default":
        return jax.lax.Precision.DEFAULT, None
    if name == "bf16":
        return None, jnp.bfloat16
    raise ValueError(f"unknown precision {name!r}")


def _best_split(n: int) -> tuple[int, int]:
    """Split n = n1 * n2 with both factors as close to sqrt(n) (and matmul-
    friendly) as possible.  n must be even; powers of two expected."""
    best = (1, n)
    for n1 in range(1, int(np.sqrt(n)) + 1):
        if n % n1 == 0:
            best = (n1, n // n1)
    return best


@dataclasses.dataclass(frozen=True)
class BandSpec:
    """Output bins: [0, nlo) and [F - nhi, F)."""

    nlo: int
    nhi: int


class ZoomDftPlan:
    """Precomputed matrices for one (N, F, bands, dechirp-vector) combination.

    ``__call__(frames)`` maps float32 [..., N, 2] -> (lo [..., nlo, 2],
    hi [..., nhi, 2]).
    """

    def __init__(self, n: int, fft_size: int, bands: BandSpec,
                 modulation: np.ndarray, force_four_step: bool | None = None,
                 precision: str = "highest"):
        self._lax_precision, self._compute_dtype = _resolve_precision(precision)
        assert fft_size % n == 0, "fft_size must be a multiple of the frame length"
        self.n = n
        self.fft_size = fft_size
        self.bands = bands
        factor = fft_size // n
        self.factor = factor
        v = np.asarray(modulation, dtype=np.complex128)
        if v.ndim == 1:
            v = v[None, :]
        self.num_variants = v.shape[0]
        assert v.shape[1] == n

        total_bins = (bands.nlo + bands.nhi) * self.num_variants
        use_four = (n * total_bins > _DIRECT_MAX_ELEMS) if force_four_step is None \
            else force_four_step

        if not use_four:
            self._mode = "direct"
            k = np.concatenate([
                np.arange(bands.nlo),
                np.arange(fft_size - bands.nhi, fft_size),
            ]).astype(np.float64)
            ang = -2j * np.pi * np.outer(np.arange(n), k) / fft_size
            e = np.exp(ang)
            # All modulation variants (e.g. windowed + unwindowed dechirp)
            # share one packed matmul: columns concatenated per variant.
            w = np.concatenate([e * v[i][:, None]
                                for i in range(self.num_variants)], axis=1)
            # Kept as NumPy so a plan built inside a jit trace holds no
            # tracers; they enter each trace as constants.
            self._w2 = pack_cmatmul_weights(
                w.real.astype(np.float32), w.imag.astype(np.float32))
        else:
            assert self.num_variants == 1, \
                "four-step path supports a single modulation variant"
            v = v[0]
            self._mode = "four_step"
            assert bands.nlo % factor == 0 and bands.nhi % factor == 0, \
                "band widths must be multiples of fft_factor for the four-step path"
            n1, n2 = _best_split(n)
            self._n1, self._n2 = n1, n2
            # Per-r modulation: dechirp * pad twiddle, shape [factor, N].
            r = np.arange(factor)[:, None]
            tw_r = np.exp(-2j * np.pi * r * np.arange(n)[None, :] / fft_size)
            mod = (tw_r * v[None, :]).astype(np.complex128)
            self._mod = np.stack([mod.real, mod.imag], axis=-1).astype(np.float32)
            # DFT matrices and the inter-step twiddle.
            f1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
            f2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
            # A[n1, n2] with n = n1*N2 + n2; X[k1 + N1*k2] =
            #   sum_n2 (w^(n2*k1) * sum_n1 A[n1,n2] e^(-2pi i n1 k1/N1)) e^(-2pi i n2 k2/N2)
            tw = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n)  # [k1, n2]
            self._f1_re = f1.real.astype(np.float32)
            self._f1_im = f1.imag.astype(np.float32)
            self._f2_re = f2.real.astype(np.float32)
            self._f2_im = f2.imag.astype(np.float32)
            self._tw = np.stack([tw.real, tw.imag], axis=-1).astype(np.float32)

    @property
    def mode(self) -> str:
        return self._mode

    def __call__(self, frames: jnp.ndarray):
        if self._mode == "direct":
            out = cmatmul_packed(frames, self._w2,
                                 precision=self._lax_precision,
                                 compute_dtype=self._compute_dtype)
            per = self.bands.nlo + self.bands.nhi
            outs = [
                (out[..., i * per:i * per + self.bands.nlo, :],
                 out[..., i * per + self.bands.nlo:(i + 1) * per, :])
                for i in range(self.num_variants)
            ]
            return outs[0] if self.num_variants == 1 else outs
        return self._four_step(frames)

    def _four_step(self, frames: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
        n1, n2, factor = self._n1, self._n2, self.factor
        lead = frames.shape[:-2]
        x = cmul(frames[..., None, :, :], self._mod)  # [..., factor, N, 2]
        a = x.reshape(*lead, factor, n1, n2, 2)
        # Step 1: DFT over n1 (contract axis -3). Move n1 last: [..., n2, n1, 2].
        a_t = jnp.swapaxes(a, -3, -2)
        c = cmatmul(a_t, self._f1_re, self._f1_im,
                    precision=self._lax_precision,
                    compute_dtype=self._compute_dtype)  # [..., n2, k1, 2]
        # Step 2: twiddle w^(n2*k1); self._tw is [k1, n2] -> transpose.
        tw_t = jnp.swapaxes(self._tw, 0, 1)  # [n2, k1, 2]
        c = cmul(c, tw_t)
        # Step 3: DFT over n2: move n2 last again: [..., k1, n2, 2].
        c_t = jnp.swapaxes(c, -3, -2)
        d = cmatmul(c_t, self._f2_re, self._f2_im,
                    precision=self._lax_precision,
                    compute_dtype=self._compute_dtype)  # [..., k1, k2, 2]
        # X[k1 + N1*k2] -> index m: reorder to [k2, k1] then flatten.
        xr = jnp.swapaxes(d, -3, -2).reshape(*lead, factor, self.n, 2)
        # Padded-FFT bins: bin (factor*m + r) = X_r[m]; pack [m, r] row-major.
        nlo_m = self.bands.nlo // factor
        nhi_m = self.bands.nhi // factor
        lo = jnp.swapaxes(xr[..., :, :nlo_m, :], -3, -2).reshape(*lead, self.bands.nlo, 2)
        hi = jnp.swapaxes(xr[..., :, self.n - nhi_m:, :], -3, -2).reshape(*lead, self.bands.nhi, 2)
        return lo, hi
