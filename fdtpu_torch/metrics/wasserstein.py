"""Wasserstein distances between datasets (numpy; a copy of
``fdtpu/metrics/wasserstein.py:18-123``, kept in the port so that it imports
nothing of the JAX package).

The exact 1-D W₂² comes from the quantile-coupling closed form (what POT's
``ot.emd2_1d`` computes for uniform weights), and the sliced distance is one
matmul and a batched sort over all directions.  Directions are drawn with
``np.random.default_rng(seed)`` in the JAX package's order, so sliced
distances agree with it draw for draw.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def wasserstein2_1d(a: np.ndarray, b: np.ndarray) -> float:
    """Exact squared 2-Wasserstein distance between two 1-D empirical
    distributions with uniform weights (any sample counts).

    Equals POT's ``ot.emd2_1d(a, b)`` (sqeuclidean metric).
    """
    w2 = batched_wasserstein2_1d(a[None, :], b[None, :])
    return float(w2[0])


def batched_wasserstein2_1d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared 1-D W₂ for a batch of projections.

    Args:
        a: ``(P, Na)`` samples per projection.
        b: ``(P, Nb)``.

    Returns:
        ``(P,)`` squared distances.
    """
    na, nb = a.shape[1], b.shape[1]
    a = np.sort(a, axis=1)
    b = np.sort(b, axis=1)
    # Quantile breakpoints of both empirical CDFs (shared across the batch).
    q = np.union1d(np.arange(1, na + 1) / na, np.arange(1, nb + 1) / nb)
    dq = np.diff(np.concatenate([[0.0], q]))
    mid = q - dq / 2  # interior point of each segment (avoids breakpoints)
    ia = np.clip(np.floor(mid * na).astype(int), 0, na - 1)
    ib = np.clip(np.floor(mid * nb).astype(int), 0, nb - 1)
    diff = a[:, ia] - b[:, ib]
    return (diff**2 * dq[None, :]).sum(axis=1)


class WassersteinDistances:
    """Sliced / marginal Wasserstein distances (reference API parity).

    Parameters mirror the reference class; ``seed`` feeds
    ``np.random.default_rng`` exactly like wasserstein.py:40 so direction
    sampling is reproducible.
    """

    def __init__(
        self,
        original_data: np.ndarray,
        other_data: np.ndarray,
        normalisation: Optional[str] = "none",
        seed: Optional[int] = None,
    ) -> None:
        self.original_data = np.asarray(original_data)
        self.other_data = np.asarray(other_data)
        self.normalisation = normalisation
        self.rng = np.random.default_rng(seed)

    def random_direction(self, dim: int) -> np.ndarray:
        vector = self.rng.normal(size=dim)
        return vector / np.linalg.norm(vector)

    def get_random_directions(self, n_directions: int) -> list[np.ndarray]:
        dim = self.original_data.shape[1]
        return [self.random_direction(dim) for _ in range(n_directions)]

    def get_marginal_directions(self) -> list[np.ndarray]:
        dim = self.original_data.shape[1]
        return [np.identity(dim)[i] for i in range(dim)]

    def _normalise(
        self, orig: np.ndarray, other: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        if self.normalisation == "none":
            return orig, other
        if self.normalisation == "standardise":
            sd = np.std(orig)
            return orig / sd, other / sd
        raise ValueError(f"Unrecognised normalisation type: {self.normalisation}")

    def feature_distance(self, feature: int) -> float:
        orig, other = self._normalise(
            self.original_data[:, feature], self.other_data[:, feature]
        )
        return float(np.sqrt(wasserstein2_1d(orig, other)))

    def directional_distance(self, direction: np.ndarray) -> float:
        orig, other = self._normalise(
            self.original_data @ direction, self.other_data @ direction
        )
        return float(np.sqrt(wasserstein2_1d(orig, other)))

    def sliced_distances(self, num_directions: int) -> np.ndarray:
        """√W₂² over random unit directions — vectorized over all directions."""
        dirs = np.stack(self.get_random_directions(num_directions))  # (P, D)
        proj_orig = (self.original_data @ dirs.T).T  # (P, N)
        proj_other = (self.other_data @ dirs.T).T
        if self.normalisation == "standardise":
            sd = proj_orig.std(axis=1, keepdims=True)
            proj_orig = proj_orig / sd
            proj_other = proj_other / sd
        return np.sqrt(batched_wasserstein2_1d(proj_orig, proj_other))

    def marginal_distances(self) -> np.ndarray:
        """√W₂² per feature — vectorized over all features."""
        orig = self.original_data.T  # (D, N)
        other = self.other_data.T
        if self.normalisation == "standardise":
            sd = orig.std(axis=1, keepdims=True)
            orig, other = orig / sd, other / sd
        return np.sqrt(batched_wasserstein2_1d(orig, other))
