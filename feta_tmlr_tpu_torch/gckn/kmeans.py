"""Spherical k-means for the GCKN anchors (filters).

The counterpart of the JAX package's `gckn/kmeans.py` (the reference's
`spherical_kmeans` with kmeans++ seeding, gckn/utils.py): unit-norm
samples, cosine-similarity assignment, renormalised centroids.
`kmeans_plus_plus` and `spherical_kmeans` run in numpy on the host and give
the JAX package's centres bit for bit from the same seed;
`spherical_kmeans_torch` runs the Lloyd loop on a device, with the JAX
package's `spherical_kmeans_jax` semantics (one-hot products for the
centroid sums, all empty clusters refilled at once).
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-6


def _normalize(x):
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, EPS)


def kmeans_plus_plus(x, n_clusters, rng):
    """kmeans++ seeding on cosine distance.

    Samples are unit-normalised per path position, so the flattened dot
    product of two identical samples is path_size, not 1: the distance is
    path_size - sim (the reference's norm=kmer_size)."""
    n = x.shape[0]
    path_size = int(np.prod(x.shape[1:-1])) or 1
    centers = np.empty((n_clusters,) + x.shape[1:], dtype=x.dtype)
    idx = rng.integers(n)
    centers[0] = x[idx]
    closest = path_size - x.reshape(n, -1) @ centers[0].reshape(-1)
    closest = np.maximum(closest, 0)
    for c in range(1, n_clusters):
        total = closest.sum()
        if total <= EPS:
            # every remaining point coincides with a chosen centre
            # (common for discrete features): uniform seeding
            idx = rng.integers(n)
        else:
            probs = np.asarray(closest, np.float64) / total
            probs = probs / probs.sum()
            idx = rng.choice(n, p=probs)
        centers[c] = x[idx]
        d = path_size - x.reshape(n, -1) @ centers[c].reshape(-1)
        closest = np.minimum(closest, np.maximum(d, 0))
    return centers


def spherical_kmeans(x, n_clusters, n_iters: int = 100, seed: int = 0,
                     tol: float = 1e-4, verbose: bool = False,
                     init_centers=None):
    """x: [n, path_size, input] samples (normalised here).

    Returns centroids [n_clusters, path_size, input] float32 with unit
    rows. `init_centers` replaces the kmeans++ seeding."""
    rng = np.random.default_rng(seed)
    x = _normalize(np.asarray(x, dtype=np.float64))
    n = x.shape[0]
    flat = x.reshape(n, -1)
    if init_centers is not None:
        centers = np.array(init_centers, dtype=np.float64)
    else:
        centers = kmeans_plus_plus(x, n_clusters, rng)
    prev_sim = -np.inf
    for it in range(n_iters):
        cflat = centers.reshape(n_clusters, -1)
        sim = flat @ cflat.T                       # cosine similarity
        assign = sim.argmax(1)
        best = sim[np.arange(n), assign]
        mean_sim = best.mean()
        for c in range(n_clusters):
            members = flat[assign == c]
            if len(members) == 0:
                # the reference's policy: take the least well represented
                # point, and mark it taken
                idx = int(best.argmin())
                centers[c] = x[idx]
                best[idx] = 1.0
            else:
                centers[c] = _normalize(
                    members.mean(0).reshape(centers.shape[1:]))
        if verbose:
            print(f"kmeans iter {it}: sim={mean_sim:.5f}")
        if abs(mean_sim - prev_sim) < tol:
            break
        prev_sim = mean_sim
    return centers.astype(np.float32)


def spherical_kmeans_torch(x, n_clusters, n_iters: int = 100,
                           seed: int = 0, tol: float = 1e-4,
                           init_centers=None, device=None):
    """The Lloyd loop on `device` in float32, as the JAX package's
    `spherical_kmeans_jax`: assignment and centroid sums are two products
    (one-hot, no scatter); empty clusters are refilled together, the j-th
    empty one with the point of the j-th lowest best similarity (the numpy
    loop takes them one at a time; the same when at most one cluster
    empties in an iteration). The kmeans++ seeding stays on the host
    unless `init_centers` is given. Returns float32 numpy centroids."""
    x32 = _normalize(np.asarray(x, dtype=np.float64)).astype(np.float32)
    if init_centers is not None:
        centers0 = np.asarray(init_centers, dtype=np.float32)
    else:
        rng = np.random.default_rng(seed)
        centers0 = kmeans_plus_plus(x32.astype(np.float64), n_clusters,
                                    rng).astype(np.float32)
    n = x32.shape[0]
    inner = int(np.prod(x32.shape[1:]))
    flat = torch.from_numpy(x32.reshape(n, inner)).to(device)
    centers = torch.from_numpy(centers0.reshape(n_clusters, inner)).to(
        device)
    # the convergence test in float32, as the JAX loop's
    prev_sim, cur_sim = np.float32(-np.inf), np.float32(np.inf)
    for _ in range(n_iters):
        if not np.abs(cur_sim - prev_sim) >= np.float32(tol):
            break
        sim = flat @ centers.T                          # [n, k]
        assign = sim.argmax(1)
        best = sim.gather(1, assign[:, None])[:, 0]
        oh = (assign[:, None] == torch.arange(
            n_clusters, device=flat.device)).to(flat.dtype)
        sums = oh.T @ flat                              # [k, inner]
        cnt = oh.sum(0)
        means = sums / torch.clamp(cnt, min=1.0)[:, None]
        means = means.reshape((n_clusters,) + x32.shape[1:])
        norm = torch.linalg.vector_norm(means, dim=-1, keepdim=True)
        means = (means / torch.clamp(norm, min=EPS)).reshape(
            n_clusters, inner)
        empty = cnt == 0
        order = torch.argsort(best, stable=True)[:n_clusters]
        rank = torch.cumsum(empty.to(torch.int32), 0) - 1
        stolen = flat[order][torch.clamp(rank, 0, n_clusters - 1)]
        centers = torch.where(empty[:, None], stolen, means)
        prev_sim, cur_sim = cur_sim, np.float32(best.mean().item())
    return centers.cpu().numpy().astype(np.float32).reshape(
        (n_clusters,) + x32.shape[1:])
