"""Plain NumPy float64 reference of the Pyramid peak lattice, and the
comparison that holds a device lattice to it.

Written from the reference's own steps (pyramid_demod_impl.cc:569-603,
:225-272), independent of the zoom-DFT matmul and overlap formulations in
ops/: per hop, dechirp the frame, zero-pad it to F = fft_factor * N and
take ``np.fft.fft``, fold the two edge bands of K bins, once unwindowed
and once Kaiser-windowed, then keep the strict cyclic local maxima of the
windowed fold above the threshold and the top M of them.
"""

from __future__ import annotations

import numpy as np

from ..config import PYRAMID_OVERLAP_FACTOR, LoraConfig


def reference_spectra(iq: np.ndarray, cfg: LoraConfig, num_hops: int):
    """iq [T, 2] or complex [T] -> float64 (fft_add, fft_add_w, h_single),
    each [num_hops, K]."""
    iq = np.asarray(iq)
    if not np.iscomplexobj(iq):
        iq = iq[..., 0].astype(np.float64) + 1j * iq[..., 1]
    n, p = cfg.num_samples, cfg.p
    hop = n // PYRAMID_OVERLAP_FACTOR
    k, f = cfg.bin_size, cfg.fft_size
    i = np.arange(n, dtype=np.float64)
    down = np.exp(1j * np.pi / p * (i - i * i / n))
    win = np.kaiser(n, cfg.beta)
    idx = np.arange(num_hops)[:, None] * hop + np.arange(n)[None, :]
    frames = iq.astype(np.complex128)[idx] * down

    def fold(x):
        spec = np.fft.fft(x, f, axis=-1)
        lo, hi = np.abs(spec[:, :k]), np.abs(spec[:, f - k:])
        return lo + hi, np.maximum(lo, hi)

    fft_add, h_single = fold(frames)
    fft_add_w, _ = fold(frames * win)
    return fft_add, fft_add_w, h_single


def reference_peaks(fft_add_w: np.ndarray, threshold: float,
                    max_peaks: int) -> list[np.ndarray]:
    """Per hop: the bins of the top ``max_peaks`` strict cyclic local
    maxima of the windowed fold above ``threshold``, highest first."""
    w = fft_add_w
    is_peak = ((w > threshold) & (w > np.roll(w, 1, axis=-1))
               & (w > np.roll(w, -1, axis=-1)))
    out = []
    for t in range(w.shape[0]):
        cand = np.nonzero(is_peak[t])[0]
        order = np.argsort(-w[t, cand], kind="stable")
        out.append(cand[order][:max_peaks])
    return out


def compare_lattice(ref, got, cfg: LoraConfig, max_peaks: int,
                    rtol: float) -> dict:
    """Hold a device lattice's output ``got`` = (bins, h, h_single, valid)
    to the reference spectra ``ref`` = reference_spectra(...).

    Tolerances are relative to each hop's largest reference height, the
    scale of a matmul's rounding error.  A bin on which the two disagree
    is a near-tie, and excused, when the decision that separates it was
    within that tolerance in the reference: its windowed height against
    the threshold, against a neighbour bin (the local-max test) or against
    the weakest peak kept (the top-M cut).  Any other disagreement is a
    mismatch.  Returns the worst height errors (relative), the mismatches
    and the near-ties as lists of ``(hop, bin, why)``."""
    fft_add, fft_add_w, h_single = ref
    bins, h, hs, valid = (np.asarray(x) for x in got)
    k = fft_add_w.shape[1]
    peaks = reference_peaks(fft_add_w, cfg.threshold, max_peaks)
    w = fft_add_w
    res = {"h_err": 0.0, "h_single_err": 0.0, "mismatch": [], "near_tie": [],
           "peaks": 0}
    for t in range(w.shape[0]):
        scale_w = w[t].max()
        tol_w = rtol * scale_w
        want = set(int(b) for b in peaks[t])
        have = set(int(b) for b in bins[t][valid[t]])
        res["peaks"] += len(want)
        cut = w[t, peaks[t][-1]] if len(peaks[t]) == max_peaks else None
        for b in sorted(want ^ have):
            v = w[t, b]
            why = []
            if abs(v - cfg.threshold) <= tol_w:
                why.append("threshold")
            if min(abs(v - w[t, (b - 1) % k]),
                   abs(v - w[t, (b + 1) % k])) <= tol_w:
                why.append("local-max")
            if cut is not None and abs(v - cut) <= tol_w:
                why.append("top-M")
            side = "device only" if b in have else "reference only"
            entry = (t, b, f"{side}: {'/'.join(why) or 'no tie'} "
                           f"(w={v:.6g}, tol={tol_w:.3g})")
            res["near_tie" if why else "mismatch"].append(entry)
        sel = valid[t]
        for b, hv, hsv in zip(bins[t][sel], h[t][sel], hs[t][sel]):
            res["h_err"] = max(res["h_err"],
                               abs(hv - fft_add[t, b]) / fft_add[t].max())
            res["h_single_err"] = max(
                res["h_single_err"],
                abs(hsv - h_single[t, b]) / h_single[t].max())
    return res
