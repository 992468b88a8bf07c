"""Synthetic datasets standing in for SIFT1M/DEEP1M/DBpedia/S&P500/Nasdaq.

This container is offline, so the public datasets cannot be fetched. We
follow the paper's *protocol* instead: vectors come from a Gaussian mixture
(clustered, like real embedding corpora), and interval metadata is drawn
from the paper's five distributions over a normalized endpoint domain
``[0, T]`` with the main setting's length cap ``0.01·T`` (§VI-A). The
``uncapped`` distribution emulates the real-world workloads of Fig. 4a
(heavy-tailed, uncapped interval lengths).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

T_DOMAIN = 1000.0  # normalized endpoint domain size T


def validate_intervals(
    s: np.ndarray,
    t: np.ndarray,
    *,
    what: str = "intervals",
    clamp: bool = False,
    require_ordered: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Boundary validation for closed intervals ``[s, t]``.

    Every downstream layer (dominance mapping, canonical grids, device rank
    labels) assumes finite endpoints with ``s <= t``; violations produced
    upstream would silently corrupt the index, so they are rejected here —
    or, with ``clamp=True``, degenerate spans are clamped to the
    zero-length interval at ``min(s, t)``. Returns float64 ``(s, t)``.

    ``require_ordered=False`` keeps only the finiteness check: the serving
    boundary uses it because batch padding encodes no-op rows as ``s > t``
    (empty valid set) on purpose, while NaN/Inf would still silently poison
    every distance they touch.
    """
    s = np.atleast_1d(np.asarray(s, dtype=np.float64))
    t = np.atleast_1d(np.asarray(t, dtype=np.float64))
    if s.shape != t.shape:
        raise ValueError(f"{what}: shape mismatch {s.shape} vs {t.shape}")
    if not (np.all(np.isfinite(s)) and np.all(np.isfinite(t))):
        raise ValueError(f"{what}: non-finite endpoints")
    if not require_ordered:
        return s, t
    bad = s > t
    if np.any(bad):
        if clamp:
            lo = np.minimum(s, t)
            s = np.where(bad, lo, s)
            t = np.where(bad, lo, t)
        else:
            i = int(np.argmax(bad))
            raise ValueError(
                f"{what}: {int(np.count_nonzero(bad))} degenerate span(s) "
                f"with s > t (first at index {i}: s={s[i]!r}, t={t[i]!r})"
            )
    return s, t


def make_vectors(
    n: int,
    dim: int,
    *,
    clusters: int = 16,
    seed: int = 0,
    spread: float = 0.35,
) -> np.ndarray:
    """Gaussian-mixture vectors, unit-scaled; float32 [n, dim]."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, dim))
    asg = rng.integers(0, clusters, size=n)
    x = centers[asg] + spread * rng.normal(size=(n, dim))
    return np.ascontiguousarray(x, dtype=np.float32)


def make_queries_vectors(
    nq: int, dim: int, *, clusters: int = 16, seed: int = 1, spread: float = 0.35
) -> np.ndarray:
    """Query vectors from the same mixture family (fresh draws)."""
    return make_vectors(nq, dim, clusters=clusters, seed=seed, spread=spread)


# --- interval metadata distributions (paper §VI-A + Fig. 5) --------------------


def _lengths_capped(rng: np.random.Generator, n: int, T: float) -> np.ndarray:
    return rng.uniform(0.0, 0.01 * T, size=n)


def _uniform(rng: np.random.Generator, n: int, T: float) -> Tuple[np.ndarray, np.ndarray]:
    """Main synthetic setting: length ~ U(0, 0.01T), start uniform over the
    feasible range conditioned on length."""
    ln = _lengths_capped(rng, n, T)
    s = rng.uniform(0.0, T - ln)
    return s, s + ln


def _normal(rng: np.random.Generator, n: int, T: float) -> Tuple[np.ndarray, np.ndarray]:
    ln = _lengths_capped(rng, n, T)
    s = np.clip(rng.normal(0.5 * T, 0.15 * T, size=n), 0.0, T - ln)
    return s, s + ln


def _skewed(rng: np.random.Generator, n: int, T: float) -> Tuple[np.ndarray, np.ndarray]:
    ln = _lengths_capped(rng, n, T)
    s = np.clip(T * rng.beta(0.6, 3.0, size=n), 0.0, T - ln)
    return s, s + ln


def _clustered(rng: np.random.Generator, n: int, T: float) -> Tuple[np.ndarray, np.ndarray]:
    k = 8
    centers = rng.uniform(0.05 * T, 0.95 * T, size=k)
    ln = _lengths_capped(rng, n, T)
    s = centers[rng.integers(0, k, size=n)] + rng.normal(0.0, 0.02 * T, size=n)
    s = np.clip(s, 0.0, T - ln)
    return s, s + ln


def _hollow(rng: np.random.Generator, n: int, T: float) -> Tuple[np.ndarray, np.ndarray]:
    """Bimodal: starts avoid the middle of the domain."""
    ln = _lengths_capped(rng, n, T)
    side = rng.random(n) < 0.5
    s = np.where(
        side,
        T * rng.beta(2.0, 8.0, size=n),          # low region
        T * (1.0 - rng.beta(2.0, 8.0, size=n)),  # high region
    )
    s = np.clip(s, 0.0, T - ln)
    return s, s + ln


def _uncapped(rng: np.random.Generator, n: int, T: float) -> Tuple[np.ndarray, np.ndarray]:
    """Real-world emulation (Fig. 4a): heavy-tailed lengths, no cap."""
    ln = np.minimum(T * rng.lognormal(mean=-4.5, sigma=1.6, size=n), T)
    s = rng.uniform(0.0, np.maximum(T - ln, 1e-9))
    return s, np.minimum(s + ln, T)


INTERVAL_DISTRIBUTIONS: Dict[str, object] = {
    "uniform": _uniform,
    "normal": _normal,
    "skewed": _skewed,
    "clustered": _clustered,
    "hollow": _hollow,
    "uncapped": _uncapped,
}


def make_intervals(
    n: int, *, distribution: str = "uniform", T: float = T_DOMAIN, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample n closed intervals [s, t] from a named distribution."""
    try:
        fn = INTERVAL_DISTRIBUTIONS[distribution]
    except KeyError:
        raise KeyError(
            f"unknown interval distribution {distribution!r}; "
            f"supported: {sorted(INTERVAL_DISTRIBUTIONS)}"
        ) from None
    rng = np.random.default_rng(seed + 7919)
    s, t = fn(rng, n, T)  # type: ignore[operator]
    s, t = validate_intervals(s, t, what=f"{distribution} intervals")
    # Quantize endpoints to f32-representable values so device-side (f32)
    # canonicalization is exact — label ranks then agree bit-for-bit between
    # the host index and TPU shards. Rounding can reorder endpoints of
    # near-zero-length spans, so clamp those back to degenerate intervals.
    s = s.astype(np.float32).astype(np.float64)
    t = t.astype(np.float32).astype(np.float64)
    return validate_intervals(s, t, what=f"{distribution} intervals", clamp=True)


def make_dataset(
    n: int,
    dim: int,
    *,
    distribution: str = "uniform",
    T: float = T_DOMAIN,
    seed: int = 0,
    clusters: int = 16,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(vectors, s, t) with matched seeds — the standard benchmark input."""
    vecs = make_vectors(n, dim, clusters=clusters, seed=seed)
    s, t = make_intervals(n, distribution=distribution, T=T, seed=seed)
    return vecs, s, t
