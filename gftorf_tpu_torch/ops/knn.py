"""Mean k-nearest-neighbour squared distance for Gaussian scale init.

Port of ``gftorf_tpu/ops/knn.py`` (the reference's simple-knn extension,
simple_knn.cu:185-221): for every point the mean of its k smallest
squared distances to the other points, used once at init for
``scales = log(sqrt(mean_knn_sq_dist(points)))``
(scene/gaussian_model.py:194-199).

Exact, in row chunks on the points' device. The distances are the direct
differences ``dx*dx + dy*dy + dz*dz``, as the JAX package's host scan
(``native/knn.cpp``) computes them; the ``|a|^2 - 2ab + |b|^2`` form of a
matmul (``torch.cdist``, the JAX package's on-device fallback) cancels
catastrophically for near neighbours far from the origin.
"""

from __future__ import annotations

import torch


def mean_knn_sq_dist(points: torch.Tensor, k: int = 3,
                     chunk_elems: int = 1 << 26) -> torch.Tensor:
    """(P,) mean of the k smallest squared distances to the other points
    (the point itself excluded by index; duplicates count as distance 0).

    ``chunk_elems`` bounds the (rows, P) distance block of one chunk.
    """
    pts = points.to(torch.float32)
    n = pts.shape[0]
    if n <= 1:
        return pts.new_zeros((n,))
    k = min(k, n - 1)
    rows = max(1, chunk_elems // n)
    cols = pts.T.contiguous()  # (3, P)
    out = []
    for r0 in range(0, n, rows):
        blk = pts[r0:r0 + rows]
        d = ((blk[:, 0:1] - cols[0]) ** 2 + (blk[:, 1:2] - cols[1]) ** 2
             + (blk[:, 2:3] - cols[2]) ** 2)
        own = torch.arange(r0, r0 + blk.shape[0], device=pts.device)
        d[torch.arange(blk.shape[0], device=pts.device), own] = float("inf")
        near = torch.topk(d, k, dim=1, largest=False, sorted=True).values
        out.append(near.mean(dim=1))
    return torch.cat(out)
