"""Tests for the zoom-DFT matmul, chirp tables and peak search."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_lora_tpu import LoraConfig, PeakSearch
from gr_lora_tpu.core import encode
from gr_lora_tpu.models.modulator import modulate
from gr_lora_tpu.ops.chirp import chirp_tables, mod_reference_tables
from gr_lora_tpu.ops.cplx import from_ri, to_ri
from gr_lora_tpu.ops.dechirp import down_peak, frame_signal, up_peak
from gr_lora_tpu.ops.dft import BandSpec, ZoomDftPlan


@pytest.mark.parametrize("n,fac,nlo,nhi,force", [
    (512, 2, 512, 512, False),
    (512, 2, 512, 512, True),
    (256, 1, 256, 256, False),
    (1024, 4, 2048, 1024, True),
    (2048, 2, 2048, 2048, True),
])
def test_zoom_dft_matches_numpy_fft(n, fac, nlo, nhi, force):
    rng = np.random.default_rng(n + fac)
    F = fac * n
    x = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    v = np.exp(1j * rng.standard_normal(n)).astype(np.complex64)
    plan = ZoomDftPlan(n, F, BandSpec(nlo, nhi), v, force_four_step=force)
    lo, hi = jax.jit(plan.__call__)(jnp.asarray(to_ri(x)))
    ref = np.fft.fft(x * v, n=F, axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(from_ri(np.asarray(lo)) - ref[:, :nlo]).max() / scale < 1e-5
    assert np.abs(from_ri(np.asarray(hi)) - ref[:, F - nhi:]).max() / scale < 1e-5


def test_direct_mode_selected_for_small_plans():
    v = np.ones(512, np.complex64)
    assert ZoomDftPlan(512, 1024, BandSpec(512, 512), v).mode == "direct"
    big = np.ones(8192, np.complex64)
    assert ZoomDftPlan(8192, 32768, BandSpec(16384, 16384), big).mode == "four_step"


def test_chirp_tables_period_and_conjugacy():
    up, down = chirp_tables(8, 2)
    assert up.shape == (512,)
    assert np.allclose(up * down, 1.0, atol=1e-6)
    assert np.allclose(np.abs(up), 1.0, atol=1e-6)
    # mod-convention table differs from closed form only by a constant phase
    # and a half-bin ramp (checked implicitly by the loopback tests).
    mup, mdown = mod_reference_tables(8)
    assert mup.shape == (256,)
    assert np.allclose(np.abs(mup), 1.0, atol=1e-6)


@pytest.mark.parametrize("sf,p,fac", [(7, 2, 2), (8, 2, 2), (8, 4, 2), (10, 2, 4)])
def test_tx_symbols_recoverable_by_up_peak(sf, p, fac):
    cfg = LoraConfig(sf=sf, cr=1, crc=True, ldr=False, explicit_header=(sf != 6),
                     p=p, fft_factor=fac)
    syms = encode(bytes([1, 2, 3, 4, 5, 6]), cfg)
    iq = modulate(syms, cfg)
    n = cfg.num_samples
    pay_start = 4 * n + int(12.25 * n)
    frames = frame_signal(jnp.asarray(to_ri(iq)), n, n, len(syms), start=pay_start)
    idx, val = jax.jit(lambda f: up_peak(f, cfg))(frames)
    meas = (np.asarray(idx) / cfg.fft_factor).round().astype(int) % cfg.num_symbols
    assert np.array_equal(meas, np.asarray(syms))


def test_sfd_down_peak_beats_up_peak():
    cfg = LoraConfig(sf=8, p=2, fft_factor=2)
    iq = modulate(np.array([5], np.uint16), cfg)
    n = cfg.num_samples
    sfd = frame_signal(jnp.asarray(to_ri(iq)), n, n, 1, start=4 * n + 10 * n)
    _, dv = down_peak(sfd, cfg)
    _, uv = up_peak(sfd, cfg)
    assert float(dv[0]) > float(uv[0])
    # and on a preamble window the up peak wins
    pre = frame_signal(jnp.asarray(to_ri(iq)), n, n, 1, start=4 * n)
    _, dv2 = down_peak(pre, cfg)
    _, uv2 = up_peak(pre, cfg)
    assert float(uv2[0]) > float(dv2[0])


@pytest.mark.parametrize("alg", [PeakSearch.ABS, PeakSearch.PHASE, PeakSearch.B])
def test_peak_algorithms_find_clean_tone(alg):
    cfg = LoraConfig(sf=8, p=2, fft_factor=2, peak_search=alg)
    up, _ = chirp_tables(cfg.sf, cfg.p)
    sym = 42
    sig = np.roll(up, -sym * cfg.p)[None]
    idx, val = up_peak(jnp.asarray(to_ri(sig)), cfg)
    assert int(idx[0]) // cfg.fft_factor % cfg.num_symbols == sym
