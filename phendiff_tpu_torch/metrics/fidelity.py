"""Generative metrics: FID / ISC / KID + on-disk feature caching.

The port's own copy of ``phendiff_tpu/metrics/fidelity.py`` (numpy and
scipy only, the same float64 math and the same seeded KID subsets; it
calls ``scipy.linalg.sqrtm`` in the form every SciPy release takes).
Capability parity with the reference's use of ``torch_fidelity``
(``utils_training.py:947-1001``, ``utils_Img2Img.py:462-563``):

* FID between generated and reference sets (the reference's default
  ``main_metric``), per class and pooled;
* ISC (Inception Score) of the generated set;
* KID with subset resampling (``kid_subset_size``, auto-disabled when the
  sample count is too small, cf. ``utils_Img2Img.py:476-482``);
* persistent reference-feature caching equivalent to torch-fidelity's
  ``cache_root`` / ``input2_cache_name`` (shared ``.fidelity_cache`` dir,
  ``train.py:86-88``).

The metric *math* runs on the host in float64 (2048-dim moments); the
feature extraction runs batched on the device (see ``inception.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import scipy.linalg


# ---------------------------------------------------------------------------
# FID
# ---------------------------------------------------------------------------


def compute_statistics(features: np.ndarray):
    """(mu, sigma) of an [N, D] feature matrix, float64."""
    f = np.asarray(features, dtype=np.float64)
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2))."""
    diff = mu1 - mu2
    # sqrtm without ``disp``: SciPy 1.18 removed the argument (the JAX
    # package's copy passes disp=False); the matrix computed is the same.
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    return frechet_distance(*compute_statistics(real), *compute_statistics(fake))


# ---------------------------------------------------------------------------
# ISC
# ---------------------------------------------------------------------------


def isc_from_logits(logits: np.ndarray, splits: int = 10) -> Dict[str, float]:
    """Inception Score: exp(E_x KL(p(y|x) || p(y))), mean/std over splits."""
    logits = np.asarray(logits, dtype=np.float64)
    logits = logits - logits.max(axis=1, keepdims=True)
    probs = np.exp(logits)
    probs /= probs.sum(axis=1, keepdims=True)
    n = len(probs)
    scores = []
    for part in np.array_split(probs, min(splits, n)):
        marginal = part.mean(axis=0, keepdims=True)
        kl = np.sum(part * (np.log(part + 1e-12) - np.log(marginal + 1e-12)), axis=1)
        scores.append(np.exp(kl.mean()))
    return {
        "inception_score_mean": float(np.mean(scores)),
        "inception_score_std": float(np.std(scores)),
    }


# ---------------------------------------------------------------------------
# KID
# ---------------------------------------------------------------------------


def _polynomial_mmd(x: np.ndarray, y: np.ndarray, degree=3, gamma=None, coef0=1.0):
    d = x.shape[1]
    gamma = gamma if gamma is not None else 1.0 / d
    kxx = (gamma * x @ x.T + coef0) ** degree
    kyy = (gamma * y @ y.T + coef0) ** degree
    kxy = (gamma * x @ y.T + coef0) ** degree
    m = x.shape[0]
    n = y.shape[0]
    sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    sum_xy = kxy.mean()
    return sum_xx + sum_yy - 2 * sum_xy


def kid_from_features(
    real: np.ndarray,
    fake: np.ndarray,
    subset_size: int = 1000,
    num_subsets: int = 100,
    seed: int = 0,
) -> Dict[str, float]:
    """Kernel Inception Distance with subset resampling (torch-fidelity
    semantics: subsets of ``subset_size`` drawn with replacement across
    subsets, without within)."""
    real = np.asarray(real, dtype=np.float64)
    fake = np.asarray(fake, dtype=np.float64)
    subset_size = min(subset_size, len(real), len(fake))
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(num_subsets):
        r = real[rng.choice(len(real), subset_size, replace=False)]
        f = fake[rng.choice(len(fake), subset_size, replace=False)]
        vals.append(_polynomial_mmd(r, f))
    return {
        "kernel_inception_distance_mean": float(np.mean(vals)),
        "kernel_inception_distance_std": float(np.std(vals)),
    }


# ---------------------------------------------------------------------------
# Feature cache (parity with torch-fidelity cache_root/input2_cache_name)
# ---------------------------------------------------------------------------


class FeatureCache:
    """Disk cache of reference-set features, keyed by name."""

    def __init__(self, cache_root: str):
        self.cache_root = cache_root
        os.makedirs(cache_root, exist_ok=True)

    def _path(self, name: str) -> str:
        safe = name.replace(os.sep, "_")
        return os.path.join(self.cache_root, f"{safe}.npz")

    def get(self, name: str) -> Optional[Dict[str, np.ndarray]]:
        p = self._path(name)
        if not os.path.exists(p):
            return None
        with np.load(p) as z:
            return {k: z[k] for k in z.files}

    def put(self, name: str, **arrays: np.ndarray) -> None:
        np.savez(self._path(name), **arrays)

    def get_or_compute(self, name: Optional[str], compute_fn):
        if name is not None:
            hit = self.get(name)
            if hit is not None:
                return hit
        out = compute_fn()
        if name is not None:
            self.put(name, **out)
        return out


# ---------------------------------------------------------------------------
# Top-level: the torch_fidelity.calculate_metrics equivalent
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MetricsConfig:
    fid: bool = True
    isc: bool = False
    kid: bool = False
    kid_subset_size: int = 1000
    kid_subsets: int = 100


def calculate_metrics(
    fake_features: np.ndarray,
    real_features: Optional[np.ndarray] = None,
    fake_logits: Optional[np.ndarray] = None,
    config: MetricsConfig = MetricsConfig(),
) -> Dict[str, float]:
    out: Dict[str, float] = {}
    if config.fid:
        if real_features is None:
            raise ValueError("FID requires real_features")
        out["frechet_inception_distance"] = fid_from_features(
            real_features, fake_features
        )
    if config.isc:
        if fake_logits is None:
            raise ValueError("ISC requires fake_logits")
        out.update(isc_from_logits(fake_logits))
    if config.kid:
        if real_features is None:
            raise ValueError("KID requires real_features")
        # reference behavior: silently skip KID when too few samples
        if (
            len(fake_features) >= config.kid_subset_size
            and len(real_features) >= config.kid_subset_size
        ):
            out.update(
                kid_from_features(
                    real_features,
                    fake_features,
                    subset_size=config.kid_subset_size,
                    num_subsets=config.kid_subsets,
                )
            )
    return out
