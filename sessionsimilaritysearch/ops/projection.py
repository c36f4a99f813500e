"""Low-rank serving projection (PCA).

Round-3 measurement: trained session encoders at flagship width produce
embeddings whose covariance spectrum has participation ratio 9-14, with
>99% of variance in the top 250 of 1600 directions.
A corpus that low-rank can be served from a PCA projection at a fraction
of the scan cost: top-k over d'=64 costs 25x less matmul/memory than d=1600
with near-zero ranking change. This module provides the projector; pair
it with any index (`DenseIndex(dim=out_dim)`) by projecting corpus rows
at build time and queries at search time with the SAME fitted projector.

Counterpart capability in the reference: none (FAISS is always fed the
raw 1600-d embeddings, fine_tune_ours.py:844-849); this is an
optimization unlocked by measuring the spectrum.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class PCAProjector(NamedTuple):
    """Fitted projection: ``project(x) = (x - mean) @ components.T``.

    components: [out_dim, d] orthonormal rows (top right-singular vectors).
    explained: fraction of total variance captured (diagnostic).
    """

    mean: np.ndarray
    components: np.ndarray
    explained: float

    def __call__(self, emb: np.ndarray, renormalize: bool = True):
        """Project [n, d] -> [n, out_dim]. ``renormalize`` re-unit-norms
        rows — the right choice for cosine serving: the projected cosine
        then equals the cosine of the projected directions, and residual
        norm lost to the dropped subspace does not bias scores.

        Type-preserving: a jax-array input projects ON DEVICE and returns
        a device array (the device-resident serving convention — a 1M-row
        corpus never crosses the host link to be projected)."""
        if isinstance(emb, jnp.ndarray) and not isinstance(emb, np.ndarray):
            x = emb.astype(jnp.float32) - jnp.asarray(self.mean)
            y = jnp.dot(x, jnp.asarray(self.components).T,
                        preferred_element_type=jnp.float32)
            if renormalize:
                n = jnp.linalg.norm(y, axis=-1, keepdims=True)
                y = y / jnp.clip(n, 1e-12)
            return y
        x = np.asarray(emb, np.float32) - self.mean
        y = x @ self.components.T
        if renormalize:
            n = np.linalg.norm(y, axis=-1, keepdims=True)
            y = y / np.clip(n, 1e-12, None)
        return y.astype(np.float32)

    def save(self, path: str) -> None:
        np.savez(path, mean=self.mean, components=self.components,
                 explained=self.explained)

    @classmethod
    def load(cls, path: str) -> "PCAProjector":
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        return cls(z["mean"], z["components"], float(z["explained"]))


def fit_itq(
    emb: np.ndarray,
    n_bits: int,
    iters: int = 50,
    sample: int = 65536,
    seed: int = 0,
) -> PCAProjector:
    """Fit a LEARNED binary-code projector (ITQ, Gong & Lazebnik CVPR'11):
    center + PCA to ``n_bits`` directions, then an orthogonal rotation R
    minimizing the quantization loss ``||sign(VR) - VR||_F`` by alternating
    minimization (fix codes -> orthogonal Procrustes for R). The rotation
    is folded into the returned projector's ``components``, so the binary
    code of x is simply ``sign(projector.project_raw(x))``.

    Why this beats SimHash on trained session encoders: their embeddings
    collapse into a narrow cone (participation ratio 9-14 at 1600-d),
    so random hyperplanes spend nearly every bit on the
    shared mean direction and carry ~no neighborhood signal (the measured
    two-stage binary-prefilter null). Centering kills
    the common component and the balanced rotation equalizes per-bit
    variance — the data-dependent code the reference trains a BinarizeHead
    for 70 epochs to get (fine_tune_ours.py:269-281, config.py:59),
    obtained here from one SVD + a few dozen tiny [bits, bits] SVDs.
    """
    n, d = emb.shape
    assert 0 < n_bits <= d, (n_bits, d)
    pca = fit_pca(emb, n_bits, sample=sample, seed=seed)
    rng = np.random.default_rng(seed)
    if n > sample:
        # sample before the host pull (see fit_pca): device corpora fit
        # from the [sample, d] gather only
        idx = rng.choice(n, sample, replace=False)
        idx.sort()
        emb = emb[idx]
    emb = np.asarray(emb, np.float32)
    V = (emb - pca.mean) @ pca.components.T  # [n, n_bits], centered
    # random orthogonal init (QR of a Gaussian), then alternate:
    # B = sign(VR); R = argmax tr(R^T V^T B) = U @ Vt from svd(V^T B)
    R = np.linalg.qr(rng.standard_normal((n_bits, n_bits)))[0].astype(
        np.float32
    )
    for _ in range(iters):
        B = np.where(V @ R >= 0, 1.0, -1.0).astype(np.float32)
        U, _, Vt = np.linalg.svd(V.T @ B, full_matrices=False)
        R = (U @ Vt).astype(np.float32)
    return PCAProjector(pca.mean, (R.T @ pca.components), pca.explained)


def itq_codes(emb: np.ndarray, projector: PCAProjector) -> np.ndarray:
    """Binary codes for a fitted ITQ projector: [n, n_bits] in {+1, -1}
    (zero projections break ties as +1, the ``simhash_codes`` convention)."""
    emb = np.asarray(emb, np.float32)
    y = (emb - projector.mean) @ projector.components.T
    return np.where(y >= 0, 1.0, -1.0).astype(np.float32)


def fit_pca(
    emb: np.ndarray, out_dim: int, sample: int = 65536, seed: int = 0
) -> PCAProjector:
    """Fit a PCA projector on (a sample of) the corpus embeddings.

    ``out_dim`` should comfortably exceed the measured participation
    ratio; the returned ``explained`` fraction is the guardrail — gate
    deployment on it (e.g. require > 0.99) plus a value_recall_at_k
    check against the full-dim oracle.
    """
    n, d = emb.shape
    assert 0 < out_dim <= d, (out_dim, d)
    if n > sample:
        # sample BEFORE materializing on host: a device-resident corpus
        # (EmbeddingPipeline out='device') only crosses the link as the
        # [sample, d] gather, never as the full [n, d] buffer (~6.4 GB at
        # 1M x 1600)
        idx = np.random.default_rng(seed).choice(n, sample, replace=False)
        idx.sort()
        emb = emb[idx]
    emb = np.asarray(emb, np.float32)
    mean = emb.mean(axis=0)
    x = (emb - mean).astype(np.float32)
    # economy SVD on the sample: components = top right-singular vectors
    _, s, vt = np.linalg.svd(x, full_matrices=False)
    var = s.astype(np.float64) ** 2
    explained = float(var[:out_dim].sum() / max(var.sum(), 1e-30))
    return PCAProjector(mean, vt[:out_dim].copy(), explained)
