"""Equal-size spectral clustering of training cameras.

A copy of ``gfnerf_tpu/sampler/clustering.py`` (numpy only), so that the
labels are identical.  Equivalent of
``gfnerf/cluster/spectral_equal_size_clustering.py`` (sklearn
SpectralClustering over a nearest-neighbour affinity + iterative equal-size
balancing) driven by ``PersSampler.train_cameras_clustering_oct``
(``gfnerf/perssampler.py:216-242``).  The reference's distance matrix is the
plain pairwise Euclidean distance between camera origins
(``get_distance_matrix_oct``, perssampler.py:170-215).

Implementation: spectral embedding of the kNN affinity (numpy's eigh of the
normalized Laplacian), k-means in embedding space, then a greedy balancing
pass that moves points from oversized to undersized clusters by embedding
distance until all cluster sizes are within one of each other.
"""

from __future__ import annotations

import numpy as np


def spectral_equal_size_clustering(
    distance_matrix: np.ndarray,
    nclusters: int,
    nneighbors: int | None = None,
    seed: int = 1234,
) -> np.ndarray:
    """Returns integer labels (n,) with near-equal cluster sizes."""
    n = distance_matrix.shape[0]
    if nclusters <= 1:
        return np.zeros(n, dtype=np.int64)
    if nneighbors is None:
        nneighbors = max(int(n * 0.1), min(n - 1, 2))
    nneighbors = min(max(nneighbors, 1), n - 1)

    # kNN affinity (symmetrized), gaussian-kernel weighted
    sigma = np.median(distance_matrix[distance_matrix > 0]) + 1e-12
    aff = np.exp(-(distance_matrix ** 2) / (2 * sigma ** 2))
    np.fill_diagonal(aff, 0.0)
    order = np.argsort(distance_matrix, axis=1)
    mask = np.zeros_like(aff, dtype=bool)
    rows = np.arange(n)[:, None]
    mask[rows, order[:, 1:nneighbors + 1]] = True
    mask = mask | mask.T
    aff = np.where(mask, aff, 0.0)

    # normalized Laplacian embedding
    deg = aff.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = np.eye(n) - (d_inv_sqrt[:, None] * aff * d_inv_sqrt[None, :])
    evals, evecs = np.linalg.eigh(lap)
    embedding = evecs[:, 1:nclusters + 1]
    norms = np.linalg.norm(embedding, axis=1, keepdims=True)
    embedding = embedding / np.maximum(norms, 1e-12)

    # k-means
    rng = np.random.default_rng(seed)
    centers = embedding[rng.choice(n, nclusters, replace=False)]
    for _ in range(50):
        d = np.linalg.norm(embedding[:, None] - centers[None], axis=-1)
        labels = d.argmin(axis=1)
        new_centers = np.stack([
            embedding[labels == k].mean(axis=0) if (labels == k).any()
            else embedding[rng.integers(n)]
            for k in range(nclusters)
        ])
        if np.allclose(new_centers, centers):
            break
        centers = new_centers

    # equal-size balancing: move farthest members of oversized clusters to
    # the nearest undersized cluster
    target = n // nclusters
    labels = labels.astype(np.int64)
    for _ in range(n):
        sizes = np.bincount(labels, minlength=nclusters)
        over = np.where(sizes > target + (1 if n % nclusters else 0))[0]
        under = np.where(sizes < target)[0]
        if len(over) == 0 or len(under) == 0:
            break
        moved = False
        for k in over:
            members = np.where(labels == k)[0]
            d_own = np.linalg.norm(embedding[members] - centers[k], axis=-1)
            # candidate = member farthest from its own center
            cand = members[np.argmax(d_own)]
            d_under = np.linalg.norm(
                centers[under] - embedding[cand], axis=-1)
            labels[cand] = under[np.argmin(d_under)]
            moved = True
            break
        if not moved:
            break

    # guarantee non-empty clusters (reference asserts this,
    # perssampler.py:240-242)
    sizes = np.bincount(labels, minlength=nclusters)
    for k in np.where(sizes == 0)[0]:
        donor = int(np.argmax(np.bincount(labels, minlength=nclusters)))
        members = np.where(labels == donor)[0]
        labels[members[0]] = k
    return labels
