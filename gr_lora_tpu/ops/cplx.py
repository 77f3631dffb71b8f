"""Complex arithmetic over real float32 pairs.

Every complex tensor on device is float32 with a trailing dim of 2
(re, im), so complex products are real matmuls (ops/dft.py).  This is also the on-disk layout of gr_complex IQ captures
(interleaved float32), so host->device ingestion is a zero-copy reinterpret.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def to_ri(x: np.ndarray) -> np.ndarray:
    """complex -> [..., 2] float32 (host-side)."""
    x = np.asarray(x, dtype=np.complex64)
    return x.view(np.float32).reshape(*x.shape, 2)


def from_ri(x) -> np.ndarray:
    """[..., 2] float32 -> complex64 (host-side)."""
    x = np.asarray(x, dtype=np.float32)
    return x[..., 0] + 1j * x[..., 1]


def cmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise complex multiply of [..., 2] pairs."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return jnp.stack([ar * br - ai * bi, ar * bi + ai * br], axis=-1)


def cmag(a: jnp.ndarray) -> jnp.ndarray:
    """|a| of [..., 2] pairs -> [...] float32."""
    return jnp.sqrt(a[..., 0] ** 2 + a[..., 1] ** 2)


def cmag2(a: jnp.ndarray) -> jnp.ndarray:
    """|a|^2 (cheaper when only comparisons are needed)."""
    return a[..., 0] ** 2 + a[..., 1] ** 2


def pack_cmatmul_weights(w_re: np.ndarray, w_im: np.ndarray) -> np.ndarray:
    """complex[N, M] -> real [2N, 2M] so one matmul computes the complex
    product: rows [Wr | Wi ; -Wi | Wr], inputs packed [xr | xi]."""
    top = np.concatenate([w_re, w_im], axis=1)
    bot = np.concatenate([-w_im, w_re], axis=1)
    return np.concatenate([top, bot], axis=0)


def cmatmul_packed(x: jnp.ndarray, w2: jnp.ndarray, precision=None,
                   compute_dtype=None) -> jnp.ndarray:
    """[..., N, 2] @ packed [2N, 2M] -> [..., M, 2] as ONE matmul.

    One [.., 2N] x [2N, 2M] product replaces the four [.., N] x [N, M]
    matmuls of the naive complex multiply — bigger, better-utilized matmul
    tiles and a single pass over the input.  ``compute_dtype=jnp.bfloat16``
    casts operands for full-rate tensor-core issue while accumulating in
    float32."""
    xp = jnp.concatenate([x[..., 0], x[..., 1]], axis=-1)
    if compute_dtype is not None:
        xp = xp.astype(compute_dtype)
        w2 = jnp.asarray(w2, compute_dtype)
    y = jnp.matmul(xp, w2, precision=precision,
                   preferred_element_type=jnp.float32)
    m = w2.shape[1] // 2
    return jnp.stack([y[..., :m], y[..., m:]], axis=-1)


def cmatmul(x: jnp.ndarray, w_re: jnp.ndarray, w_im: jnp.ndarray,
            precision=None, compute_dtype=None) -> jnp.ndarray:
    """[..., N, 2] @ complex[N, M] -> [..., M, 2] via four real matmuls.

    ``compute_dtype=jnp.bfloat16`` casts operands for full-rate tensor-core issue
    while accumulating in float32 (preferred_element_type)."""
    xr, xi = x[..., 0], x[..., 1]
    if compute_dtype is not None:
        xr, xi = xr.astype(compute_dtype), xi.astype(compute_dtype)
        w_re = jnp.asarray(w_re, compute_dtype)
        w_im = jnp.asarray(w_im, compute_dtype)

    def mm(a, b):
        return jnp.matmul(a, b, precision=precision,
                          preferred_element_type=jnp.float32)

    yr = mm(xr, w_re) - mm(xi, w_im)
    yi = mm(xr, w_im) + mm(xi, w_re)
    return jnp.stack([yr, yi], axis=-1)
