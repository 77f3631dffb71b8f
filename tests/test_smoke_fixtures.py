"""The seeded fixtures with known PDUs (gr_lora_tpu.fixtures) and the
smoke run's phases, at tiny sizes on the CPU."""

from collections import Counter

import pytest

import chip_smoke
from gr_lora_tpu import LoraConfig
from gr_lora_tpu.fixtures import (GOLDEN_PDUS, WIDEBAND_COLLISION_CH,
                                  WIDEBAND_SINGLES, check_pdus,
                                  north_star_fixture, wideband_capture)

BASE = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                  payload_len=8, p=2, fft_factor=8, threshold=5.0)


def _cfgs(sfs):
    return {sf: BASE.replace(sf=sf, ldr=(1 << sf) / 125e3 > 16e-3)
            for sf in sfs}


def test_north_star_fixture_expects_goldens_and_fitting_singles():
    iq, expected = north_star_fixture(_cfgs((7, 8, 12)), 3, 1 << 17)
    assert iq.shape == (3, 1 << 17)
    for c in range(3):
        assert {(c, 8, p) for p in GOLDEN_PDUS} <= expected
    # Round-robin singles: ch0 SF7, ch1 SF8; ch2's SF12 packet does not
    # fit the last third of a 2^17-sample window, so it is not expected.
    singles = sorted((c, sf) for c, sf, p in expected if p not in GOLDEN_PDUS)
    assert singles == [(0, 7), (1, 8)]


def test_north_star_fixture_is_seeded():
    a, ea = north_star_fixture(_cfgs((7, 8)), 2, 1 << 16, seed=4)
    b, eb = north_star_fixture(_cfgs((7, 8)), 2, 1 << 16, seed=4)
    assert ea == eb and (a == b).all()


def test_wideband_capture_layout_shifts_with_first():
    wide, expected = wideband_capture(8, 1e6, first=2)
    chans = sorted({c for c, _, _ in expected})
    want = sorted({2 + c for c in WIDEBAND_SINGLES}
                  | {2 + WIDEBAND_COLLISION_CH})
    assert chans == want
    assert len(expected) == len(WIDEBAND_SINGLES) + 2
    with pytest.raises(ValueError):
        wideband_capture(4, 0.9e6)          # not a multiple of p * bw


def test_check_pdus_reports_missing_extra_and_duplicates():
    expected = {(0, 8, "aa"), (1, 7, "bb")}
    got = Counter({(0, 8, "aa"): 2, (2, 9, "cc"): 1})
    assert check_pdus(expected, got) == {
        "missing": [(1, 7, "bb")], "extra": [(2, 9, "cc")],
        "duplicated": [(0, 8, "aa")]}
    assert check_pdus(expected, Counter(expected)) == {
        "missing": [], "extra": [], "duplicated": []}


def test_require_exact_raises_on_a_missing_pdu():
    with pytest.raises(AssertionError, match="exactly once"):
        chip_smoke.require_exact("x", {(0, 8, "aa")}, Counter())


def test_smoke_lattice_phase_on_cpu():
    chip_smoke.phase_lattice("xla", sfs=(7,), hops=16)


def test_smoke_north_star_phase_on_cpu():
    """Phase 3 at 2 channels x SF7-8 x 2^17 samples: every PDU exactly
    once through warmup, one feed and flush."""
    chip_smoke.phase_north_star(channels=2, T=1 << 17, sfs=(7, 8))


def test_smoke_cli_phase_on_cpu(tmp_path):
    """Phase 4 on the CLI's own 8 channels x 1 Msps, SF7-9 only."""
    chip_smoke.phase_cli(tmp_path, sfs="7,8,9")
