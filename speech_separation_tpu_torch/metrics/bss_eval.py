"""BSS-eval source-separation metrics, host-side numpy (counterpart of
``metrics/bss_eval.py``, a copy: the port imports nothing of the JAX package).

Implements the classic BSS-eval decompositions with time-invariant distortion
filters (the ``window=inf`` case the reference uses via
``museval.metrics.bss_eval(..., window=np.inf, hop=np.inf,
compute_permutation=True)``, `metrics/evaluate_metrics.py:79-81`).

Both estimators share one least-squares machinery: ``proj_each[j]`` is the
projection of the estimate onto ``flen`` shifted copies of reference ``j``
and ``proj_all`` the projection onto shifted copies of *all* references.

:func:`bss_eval_sources` — BSS Eval v3 *sources* variant
(``bsseval_sources_version=True``); ``s_target = proj_each[j]``:

    SDR = 10 log10 ‖s_target‖² / ‖e_interf + e_artif‖²
    SIR = 10 log10 ‖s_target‖² / ‖e_interf‖²
    SAR = 10 log10 ‖s_target + e_interf‖² / ‖e_artif‖²

:func:`bss_eval_images` — the museval v4 default the reference actually ran
(it unpacks ``(sdr, isr, sir, sar, perm)`` — ISR exists only in the images
variant); ``s_true`` is the reference itself and the distortion filter is
charged as spatial error ``e_spat = proj_each[j] − s_true``:

    SDR = 10 log10 ‖s_true‖² / ‖e_spat + e_interf + e_artif‖²
    ISR = 10 log10 ‖s_true‖² / ‖e_spat‖²
    SIR = 10 log10 ‖s_true + e_spat‖² / ‖e_interf‖²
    SAR = 10 log10 ‖s_true + e_spat + e_interf‖² / ‖e_artif‖²

Projections are computed with FFT cross-correlations and one Gram solve of
size ``nsrc * flen`` (block-Toeplitz structure; a direct solve is fast at the
default ``flen=512``); the Gram matrix is ``(nsrc·flen)²`` float64, built
per estimate. Both are held to the JAX package's functions and to a dense
convolution-matrix ``lstsq`` oracle in ``tests/test_torch_scoring.py``.
Permutation search maximises mean SIR,
breaking ties toward mean SDR, and returns metrics for the best assignment.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np

__all__ = ["bss_eval_sources", "bss_eval_images", "BssEvalResult", "BssEvalImagesResult"]


class BssEvalResult(NamedTuple):
    sdr: np.ndarray  # [nsrc]
    sir: np.ndarray  # [nsrc]
    sar: np.ndarray  # [nsrc]
    perm: np.ndarray  # [nsrc] — estimate index assigned to each reference


class BssEvalImagesResult(NamedTuple):
    sdr: np.ndarray  # [nsrc]
    isr: np.ndarray  # [nsrc] — source-image-to-spatial-distortion ratio
    sir: np.ndarray  # [nsrc]
    sar: np.ndarray  # [nsrc]
    perm: np.ndarray  # [nsrc] — estimate index assigned to each reference


def _shifted_projections(references: np.ndarray, estimate: np.ndarray, flen: int):
    """Least-squares coefficients of ``estimate`` on shifted references.

    Returns ``(proj_all, proj_each)``: the projection onto the span of all
    sources' shifts, and onto each single source's shifts, both of length
    ``T + flen - 1``.
    """
    nsrc, t = references.shape
    n_out = t + flen - 1
    nfft = 1 << int(np.ceil(np.log2(n_out)))

    rf = np.fft.rfft(references, n=nfft, axis=1)
    ef = np.fft.rfft(estimate, n=nfft)

    # Gram blocks: G[i, j, tau] = sum_t r_i[t] r_j[t - tau], tau in [-(flen-1), flen-1]
    cross = np.fft.irfft(rf[:, None, :] * np.conj(rf[None, :, :]), n=nfft, axis=2)
    # cross[i, j, tau] for tau >= 0; negative lags wrap at the end of the array
    g = np.zeros((nsrc * flen, nsrc * flen))
    for i in range(nsrc):
        for j in range(nsrc):
            c = cross[i, j]
            # block[k, l] = corr at lag (l - k)
            lags = np.arange(flen)[None, :] - np.arange(flen)[:, None]
            g[i * flen : (i + 1) * flen, j * flen : (j + 1) * flen] = c[lags % nfft]

    # RHS: d[j, k] = sum_t e[t] r_j[t - k]
    corr = np.fft.irfft(ef[None, :] * np.conj(rf), n=nfft, axis=1)
    d = corr[:, :flen].reshape(nsrc * flen)

    def _solve(gm: np.ndarray, dv: np.ndarray) -> np.ndarray:
        try:
            return np.linalg.solve(gm, dv)
        except np.linalg.LinAlgError:
            return np.linalg.lstsq(gm, dv, rcond=None)[0]

    coef_all = _solve(g, d).reshape(nsrc, flen)
    proj_all = np.zeros(n_out)
    for j in range(nsrc):
        proj_all += np.fft.irfft(np.fft.rfft(coef_all[j], n=nfft) * rf[j], n=nfft)[:n_out]

    proj_each = np.zeros((nsrc, n_out))
    for j in range(nsrc):
        gj = g[j * flen : (j + 1) * flen, j * flen : (j + 1) * flen]
        cj = _solve(gj, d[j * flen : (j + 1) * flen])
        proj_each[j] = np.fft.irfft(np.fft.rfft(cj, n=nfft) * rf[j], n=nfft)[:n_out]

    return proj_all, proj_each


def _db(num: float, den: float) -> float:
    return float(10.0 * np.log10((num + 1e-30) / (den + 1e-30)))


def bss_eval_sources(
    references: np.ndarray,
    estimates: np.ndarray,
    flen: int = 512,
    compute_permutation: bool = True,
) -> BssEvalResult:
    """BSS-eval SDR/SIR/SAR for ``references``/``estimates`` of shape [nsrc, T]."""
    references = np.asarray(references, dtype=np.float64)
    estimates = np.asarray(estimates, dtype=np.float64)
    if references.ndim != 2 or estimates.shape != references.shape:
        raise ValueError("references and estimates must both be [nsrc, T]")
    nsrc, t = references.shape
    n_out = t + flen - 1

    sdr = np.zeros((nsrc, nsrc))
    sir = np.zeros((nsrc, nsrc))
    sar = np.zeros((nsrc, nsrc))
    for e_idx in range(nsrc):
        est_pad = np.concatenate([estimates[e_idx], np.zeros(flen - 1)])
        proj_all, proj_each = _shifted_projections(references, estimates[e_idx], flen)
        e_artif = est_pad - proj_all
        for r_idx in range(nsrc):
            s_target = proj_each[r_idx]
            e_interf = proj_all - s_target
            sdr[r_idx, e_idx] = _db(
                np.sum(s_target**2), np.sum((e_interf + e_artif) ** 2)
            )
            sir[r_idx, e_idx] = _db(np.sum(s_target**2), np.sum(e_interf**2))
            sar[r_idx, e_idx] = _db(np.sum(proj_all**2), np.sum(e_artif**2))

    if compute_permutation:
        best, best_key = None, None
        for perm in itertools.permutations(range(nsrc)):
            p = np.asarray(perm)
            key = (np.mean(sir[np.arange(nsrc), p]), np.mean(sdr[np.arange(nsrc), p]))
            if best_key is None or key > best_key:
                best, best_key = p, key
        perm = best
    else:
        perm = np.arange(nsrc)

    rows = np.arange(nsrc)
    return BssEvalResult(
        sdr=sdr[rows, perm], sir=sir[rows, perm], sar=sar[rows, perm], perm=perm
    )


def bss_eval_images(
    references: np.ndarray,
    estimates: np.ndarray,
    flen: int = 512,
    compute_permutation: bool = True,
) -> BssEvalImagesResult:
    """museval-v4-style (images) SDR/ISR/SIR/SAR for ``[nsrc, T]`` signals.

    This is what the reference's ``eval_sdr`` actually computed:
    ``museval.metrics.bss_eval`` defaults to ``bsseval_sources_version=False``
    (`metrics/evaluate_metrics.py:79-81`). With ``window=inf`` the images SDR
    reduces to the plain energy ratio ``‖ref‖² / ‖est − ref‖²`` because
    ``e_spat + e_interf + e_artif = est − s_true``.
    """
    references = np.asarray(references, dtype=np.float64)
    estimates = np.asarray(estimates, dtype=np.float64)
    if references.ndim != 2 or estimates.shape != references.shape:
        raise ValueError("references and estimates must both be [nsrc, T]")
    nsrc, t = references.shape
    n_out = t + flen - 1

    sdr = np.zeros((nsrc, nsrc))
    isr = np.zeros((nsrc, nsrc))
    sir = np.zeros((nsrc, nsrc))
    sar = np.zeros((nsrc, nsrc))
    for e_idx in range(nsrc):
        est_pad = np.concatenate([estimates[e_idx], np.zeros(flen - 1)])
        proj_all, proj_each = _shifted_projections(references, estimates[e_idx], flen)
        e_artif = est_pad - proj_all
        for r_idx in range(nsrc):
            s_true = np.concatenate([references[r_idx], np.zeros(flen - 1)])
            e_spat = proj_each[r_idx] - s_true
            e_interf = proj_all - proj_each[r_idx]
            sdr[r_idx, e_idx] = _db(np.sum(s_true**2), np.sum((est_pad - s_true) ** 2))
            isr[r_idx, e_idx] = _db(np.sum(s_true**2), np.sum(e_spat**2))
            sir[r_idx, e_idx] = _db(np.sum(proj_each[r_idx] ** 2), np.sum(e_interf**2))
            sar[r_idx, e_idx] = _db(np.sum(proj_all**2), np.sum(e_artif**2))

    if compute_permutation:
        best, best_key = None, None
        for candidate in itertools.permutations(range(nsrc)):
            p = np.asarray(candidate)
            key = (np.mean(sir[np.arange(nsrc), p]), np.mean(sdr[np.arange(nsrc), p]))
            if best_key is None or key > best_key:
                best, best_key = p, key
        perm = best
    else:
        perm = np.arange(nsrc)

    rows = np.arange(nsrc)
    return BssEvalImagesResult(
        sdr=sdr[rows, perm],
        isr=isr[rows, perm],
        sir=sir[rows, perm],
        sar=sar[rows, perm],
        perm=perm,
    )
