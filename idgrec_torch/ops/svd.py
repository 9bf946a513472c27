"""Low-rank SVD of the normalized interaction matrix R̃, LightGCL's
factors (the port's own copy of idgrec_tpu/ops/svd.py, which needs only
numpy and scipy).

The factors are computed once on the host when the model is built:
scipy's sparse truncated SVD (``svds``, ARPACK) in float64, sorted by
singular value, with a numpy randomized subspace iteration when scipy
cannot run. They are model constants, not parameters.

``svds`` starts ARPACK from a random vector when it is given none, so the
JAX package's factors change from run to run (singular vectors are
defined only up to sign, and the rank-q factors only up to rotation
within a repeated singular value). Here the start vector is drawn from
``seed`` (the config's ``seed``), so two builds of one config, and so a
resumed run and a straight one, get the same factors. Runs are compared
with the JAX package through the singular values and the rank-q product
U·S·Vᵀ, not the vectors.
"""

from __future__ import annotations

import numpy as np


def lowrank_svd(r_csr, q: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rank-q SVD factors (u [m, q], s [q], v [n, q]), float32, of a
    scipy sparse ``r_csr``, largest singular value first."""
    try:
        from scipy.sparse.linalg import svds

        v0 = np.random.default_rng(seed).uniform(-1.0, 1.0, min(r_csr.shape))
        u, s, vt = svds(r_csr.astype(np.float64), k=q, v0=v0)
        order = np.argsort(-s)
        return (u[:, order].astype(np.float32), s[order].astype(np.float32),
                vt[order].T.astype(np.float32))
    except Exception:
        return _randomized_svd(r_csr, q, seed)


def _randomized_svd(r_csr, q: int, seed: int, oversample: int = 8,
                    iters: int = 4) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The fallback: a randomized range finder with ``iters`` power
    iterations (QR between them), then the exact SVD of the small
    projection; the JAX package's, draw for draw."""
    rng = np.random.default_rng(seed)
    m, n = r_csr.shape
    k = min(q + oversample, min(m, n))
    g = rng.normal(size=(n, k))
    y = r_csr @ g
    for _ in range(iters):
        y, _ = np.linalg.qr(y)
        y = r_csr @ (r_csr.T @ y)
    qmat, _ = np.linalg.qr(y)
    b = qmat.T @ r_csr
    ub, s, vt = np.linalg.svd(b, full_matrices=False)
    u = qmat @ ub
    return u[:, :q].astype(np.float32), s[:q].astype(np.float32), vt[:q].T.astype(np.float32)
