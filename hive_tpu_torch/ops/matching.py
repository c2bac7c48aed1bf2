"""Exact k-nearest-neighbour matching of SIFT descriptors, with Lowe's
ratio test.

``hive_tpu`` matches with ``cv2.FlannBasedMatcher`` (5 kd-trees, 50 checks,
``knnMatch(k=2)``), an approximate search. Here the search is exact: the
squared L2 distances of a chunk of queries to every train descriptor come
from one float64 product on the device, and the two smallest of each row
are taken (the lower index first on a tie). SIFT descriptors hold whole
numbers up to 255, so every squared distance is a whole number below 2^24:
float64 holds it exactly, and so does the float32 that FLANN sums it in.
The distance is its correctly rounded float32 square root, FLANN's
``DMatch.distance``.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Queries per chunk of the distance matrix.
_CHUNK = 4096


def knn2(query: torch.Tensor, train: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two nearest train descriptors of each query descriptor.

    :param query: (Nq, D) descriptors.
    :param train: (Nt, D) descriptors, Nt >= 2, on the same device.
    :return: indices (Nq, 2) int64 and L2 distances (Nq, 2) float32, nearest
        first.
    """
    if train.shape[0] < 2:
        raise ValueError(f"knn2 needs at least 2 train descriptors; got {train.shape[0]}")
    t = train.double()
    t_norm = (t * t).sum(dim=1)
    indices, distances = [], []
    for start in range(0, query.shape[0], _CHUNK):
        q = query[start:start + _CHUNK].double()
        d2 = (q * q).sum(dim=1, keepdim=True) + t_norm[None] - 2 * (q @ t.T)
        first = torch.argmin(d2, dim=1)
        d_first = d2.gather(1, first[:, None])[:, 0]
        d2.scatter_(1, first[:, None], float("inf"))
        second = torch.argmin(d2, dim=1)
        d_second = d2.gather(1, second[:, None])[:, 0]
        indices.append(torch.stack([first, second], dim=1))
        # The float64 root of a whole number below 2^24, rounded once to
        # float32: the correctly rounded float32 root that FLANN takes.
        distances.append(torch.sqrt(torch.stack([d_first, d_second], dim=1)).float())
    if not indices:
        return (torch.zeros((0, 2), dtype=torch.int64, device=query.device),
                torch.zeros((0, 2), dtype=torch.float32, device=query.device))
    return torch.cat(indices), torch.cat(distances)


def ratio_test(distances: torch.Tensor, ratio: float, strict: bool = True) -> torch.Tensor:
    """Lowe's test on (N, 2) float32 distances, compared in float64 as
    Python compares OpenCV's ``DMatch.distance`` values.

    :param strict: accept ``m < ratio * n`` (``hive_tpu``'s odometry);
        otherwise accept unless ``m > ratio * n`` (its feature extractor).
    """
    m, n = distances[:, 0].double(), distances[:, 1].double() * ratio
    return m < n if strict else ~(m > n)


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor, ratio: float,
                      strict: bool = True) -> torch.Tensor:
    """(M, 2) int64 (query, train) pairs of ``desc_a`` against ``desc_b``
    that pass the ratio test; none when either side has fewer than 2
    descriptors."""
    if desc_a.shape[0] < 2 or desc_b.shape[0] < 2:
        return torch.zeros((0, 2), dtype=torch.int64, device=desc_a.device)
    indices, distances = knn2(desc_a, desc_b)
    keep = ratio_test(distances, ratio, strict)
    query = torch.arange(desc_a.shape[0], device=desc_a.device)
    return torch.stack([query[keep], indices[keep, 0]], dim=1)
