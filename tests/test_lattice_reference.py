"""The plain lattice backends against the NumPy float64 reference
(models/pyramid_ref), the reference comparison itself, and the backend
dispatch of models/pyramid.peak_lattice_fn and bench.make_step."""

import numpy as np
import pytest

import jax

from gr_lora_tpu import LoraConfig
from gr_lora_tpu.fixtures import tone_fixture
from gr_lora_tpu.models.pyramid import (LATTICE_BACKENDS,
                                        lattice_formulation, num_hops_for,
                                        peak_lattice_fn)
from gr_lora_tpu.models.pyramid_ref import (compare_lattice,
                                            reference_peaks,
                                            reference_spectra)
from gr_lora_tpu.ops.cplx import to_ri

HOPS = 24
M = 8


def _cfg(sf, ff, precision="highest"):
    return LoraConfig(sf=sf, p=2, fft_factor=ff, threshold=5.0,
                      precision=precision)


def _run(cfg, backend, iq, hops=HOPS, block_hops=None):
    fn = jax.jit(peak_lattice_fn(cfg, hops, M, backend,
                                 block_hops=block_hops))
    return jax.device_get(fn(jnp_ri(iq)))


def jnp_ri(iq):
    return to_ri(np.asarray(iq, np.complex64))


@pytest.mark.parametrize("backend", LATTICE_BACKENDS)
@pytest.mark.parametrize("ff", [2, 8])
@pytest.mark.parametrize("sf", [7, 8, 9, 10, 11, 12])
def test_lattice_matches_float64_reference(sf, ff, backend):
    """f32 ('highest') lattice == float64 FFT reference: identical peak
    sets (no near-tie needed at this tolerance) and heights within 1e-5
    of each hop's largest height."""
    cfg = _cfg(sf, ff)
    iq = tone_fixture(cfg, HOPS, seed=sf + ff)
    r = compare_lattice(reference_spectra(iq, cfg, HOPS),
                        _run(cfg, backend, iq), cfg, M, rtol=1e-5)
    assert r["peaks"] >= 2 * HOPS        # both tones in every hop
    assert not r["mismatch"], r["mismatch"]
    assert not r["near_tie"], r["near_tie"]
    assert r["h_err"] <= 1e-5 and r["h_single_err"] <= 1e-5, r


@pytest.mark.parametrize("sf", [8, 11])
def test_bf16_lattice_within_stated_tolerance(sf):
    """bf16 operands: heights within 4 bf16 unit roundoffs of the hop
    maximum; every peak-set difference is an excused near-tie."""
    cfg = _cfg(sf, 8, "bf16")
    iq = tone_fixture(cfg, HOPS, seed=sf)
    r = compare_lattice(reference_spectra(iq, cfg, HOPS),
                        _run(cfg, "xla", iq), cfg, M, rtol=1.6e-2)
    assert not r["mismatch"], r["mismatch"]
    assert r["h_err"] <= 1.6e-2 and r["h_single_err"] <= 1.6e-2, r


def _fake_output(ref, cfg, hops):
    """A perfect device output built from the reference itself."""
    fft_add, fft_add_w, h_single = ref
    peaks = reference_peaks(fft_add_w, cfg.threshold, M)
    bins = np.zeros((hops, M), np.int32)
    valid = np.zeros((hops, M), bool)
    for t, p in enumerate(peaks):
        bins[t, :len(p)] = p
        valid[t, :len(p)] = True
    h = np.take_along_axis(fft_add, bins, -1)
    hs = np.take_along_axis(h_single, bins, -1)
    return bins, h, hs, valid


def test_compare_lattice_flags_a_wrong_bin():
    cfg = _cfg(8, 2)
    iq = tone_fixture(cfg, HOPS, seed=1)
    ref = reference_spectra(iq, cfg, HOPS)
    bins, h, hs, valid = _fake_output(ref, cfg, HOPS)
    assert not compare_lattice(ref, (bins, h, hs, valid), cfg, M,
                               1e-5)["mismatch"]
    k = cfg.bin_size
    bins[3, 0] = (bins[3, 0] + k // 2) % k        # far from any tie
    r = compare_lattice(ref, (bins, h, hs, valid), cfg, M, 1e-5)
    assert {t for t, _, _ in r["mismatch"]} == {3}


def test_compare_lattice_excuses_a_threshold_tie():
    """A peak whose windowed height sits within tolerance of the
    threshold may be kept or dropped: a near-tie, not a mismatch."""
    cfg = _cfg(8, 2)
    iq = tone_fixture(cfg, HOPS, seed=2)
    ref = reference_spectra(iq, cfg, HOPS)
    t = 5
    weakest = reference_peaks(ref[1], cfg.threshold, M)[t][-1]
    # The threshold just above the hop's weakest peak drops it from the
    # reference; the device output keeps it.
    tcfg = cfg.replace(threshold=float(ref[1][t, weakest]) * (1 + 1e-7))
    bins, h, hs, valid = _fake_output(ref, tcfg, HOPS)
    slot = int(valid[t].sum())
    bins[t, slot], valid[t, slot] = weakest, True
    h[t, slot], hs[t, slot] = ref[0][t, weakest], ref[2][t, weakest]
    r = compare_lattice(ref, (bins, h, hs, valid), tcfg, M, 1e-5)
    assert not r["mismatch"], r["mismatch"]
    assert [(x, y) for x, y, _ in r["near_tie"]] == [(t, weakest)]


@pytest.mark.parametrize("backend", LATTICE_BACKENDS)
def test_block_hops_matches_unblocked(backend):
    """The block_hops wrapper slices cleanly: each hop window is
    self-contained, so blocked and whole lattices agree."""
    cfg = _cfg(9, 8)
    iq = tone_fixture(cfg, 150, seed=3)
    nh = num_hops_for(cfg, len(iq))
    whole = _run(cfg, backend, iq, nh)
    blocked = _run(cfg, backend, iq, nh, block_hops=64)
    wb, wh, ws, wv = whole
    bb, bh, bs, bv = blocked
    assert np.array_equal(wv, bv)
    assert np.array_equal(wb[wv], bb[bv])
    np.testing.assert_allclose(wh[wv], bh[bv], rtol=1e-5)
    np.testing.assert_allclose(ws[wv], bs[bv], rtol=1e-5)


REMOVED = ["pallas", "fastp", "direct", "fused_direct", "rdft", "fused"]


@pytest.mark.parametrize("name", REMOVED)
@pytest.mark.parametrize("entry", ["peak_lattice_fn", "bench.make_step"])
def test_removed_backend_raises(entry, name):
    cfg = _cfg(8, 8)
    if entry == "peak_lattice_fn":
        with pytest.raises(ValueError, match="unknown lattice backend"):
            peak_lattice_fn(cfg, 16, M, name)
    else:
        import bench
        with pytest.raises(ValueError, match="unknown lattice backend"):
            bench.make_step(cfg, 16, name)


def test_xla_backend_runs_direct_only_below_the_size_cap():
    """'xla' is the direct matmul at SF7-8 x ff8 and the overlap
    decomposition from SF9 (ops/dft._DIRECT_MAX_ELEMS); 'fast' is always
    the overlap decomposition."""
    got = {sf: lattice_formulation(_cfg(sf, 8), "xla")
           for sf in range(7, 13)}
    assert got == {7: "direct", 8: "direct", 9: "overlap", 10: "overlap",
                   11: "overlap", 12: "overlap"}
    assert all(lattice_formulation(_cfg(sf, 8), "fast") == "overlap"
               for sf in range(7, 13))
