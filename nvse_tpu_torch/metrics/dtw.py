"""Dynamic time warping for DTW-aligned metrics (MCD-DTW, F0 alignment).

The reference aligns mel-cepstra with fastdtw (Metrics/mcd_utils.py:17-129,
Metrics/f0_rmse.py) before scoring; this is a plain O(N*M) DTW with an
optional Sakoe-Chiba band (the radius-constrained approximation fastdtw
makes), vectorised over the inner loop.
"""
from __future__ import annotations

import numpy as np


def dtw_path(X: np.ndarray, Y: np.ndarray, band: int | None = None):
    """DTW between frame sequences X (N, D) and Y (M, D) with Euclidean
    local cost. Returns (path_x, path_y) index arrays."""
    N, M = len(X), len(Y)
    if band is None:
        band = max(N, M)
    INF = np.inf
    D = np.full((N + 1, M + 1), INF)
    D[0, 0] = 0.0
    # local cost row by row (vectorised over M)
    step = np.zeros((N + 1, M + 1), dtype=np.int8)  # 0=diag 1=up 2=left
    for i in range(1, N + 1):
        j_lo = max(1, i - band)
        j_hi = min(M, i + band)
        cost = np.linalg.norm(Y[j_lo - 1 : j_hi] - X[i - 1], axis=1)
        # sequential inner loop due to the left (i, j-1) dependency
        for k, j in enumerate(range(j_lo, j_hi + 1)):
            c = cost[k]
            choices = (D[i - 1, j - 1], D[i - 1, j], D[i, j - 1])
            a = int(np.argmin(choices))
            D[i, j] = c + choices[a]
            step[i, j] = a
    # backtrack
    i, j = N, M
    px, py = [], []
    while i > 0 and j > 0:
        px.append(i - 1)
        py.append(j - 1)
        a = step[i, j]
        if a == 0:
            i, j = i - 1, j - 1
        elif a == 1:
            i -= 1
        else:
            j -= 1
    return np.array(px[::-1]), np.array(py[::-1])


def dtw_distance(X: np.ndarray, Y: np.ndarray, band: int | None = None) -> float:
    px, py = dtw_path(X, Y, band)
    return float(np.mean(np.linalg.norm(X[px] - Y[py], axis=1)))
