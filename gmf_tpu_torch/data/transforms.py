"""Coordinate and feature augmentation transforms and an infinite sampler.

A NumPy copy of ``gmf_tpu/data/transforms.py``, kept here because the
port imports nothing of the JAX package (reference: GMF_DGR
dataloader/transforms.py: Compose, Jitter, ChromaticShift,
sample_random_trans; dataloader/inf_sampler.py). Given the same
``RandomState`` they make the same draws in the same order.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


def rotation_about_axis(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rodrigues rotation about ``axis`` by ``theta`` radians
    (transforms.py:14-15, expm of the cross-product matrix)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return (np.eye(3) + np.sin(theta) * K
            + (1 - np.cos(theta)) * (K @ K))


def sample_random_trans(pcd: np.ndarray, randg, rotation_range: float = 360.0
                        ) -> np.ndarray:
    """Random rotation about a random axis, recentered on the cloud mean
    (transforms.py:18-23)."""
    T = np.eye(4)
    axis = randg.rand(3) - 0.5
    theta = rotation_range * np.pi / 180.0 * (float(randg.rand()) - 0.5)
    R = rotation_about_axis(axis, theta)
    T[:3, :3] = R
    T[:3, 3] = R @ (-np.mean(pcd, axis=0))
    return T


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, coords, feats):
        for t in self.transforms:
            coords, feats = t(coords, feats)
        return coords, feats


class Jitter:
    """Gaussian feature jitter, applied with probability 0.95."""

    def __init__(self, mu: float = 0.0, sigma: float = 0.01, rng=None):
        self.mu, self.sigma = mu, sigma
        self.rng = rng or np.random

    def __call__(self, coords, feats):
        if self.rng.rand() < 0.95:
            feats = feats + self.sigma * self.rng.randn(*feats.shape) + self.mu
        return coords, feats


class ChromaticShift:
    """Random RGB shift on the first three feature channels (p=0.95)."""

    def __init__(self, mu: float = 0.0, sigma: float = 0.1, rng=None):
        self.mu, self.sigma = mu, sigma
        self.rng = rng or np.random

    def __call__(self, coords, feats):
        if self.rng.rand() < 0.95:
            feats = feats.copy()
            feats[:, :3] += self.mu + self.sigma * self.rng.randn(1, 3)
        return coords, feats


class InfSampler:
    """Infinite shuffled index stream (inf_sampler.py)."""

    def __init__(self, num_samples: int, shuffle: bool = True, seed: int = 0):
        self.num_samples = num_samples
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[int]:
        while True:
            order = (self.rng.permutation(self.num_samples) if self.shuffle
                     else np.arange(self.num_samples))
            yield from order.tolist()
