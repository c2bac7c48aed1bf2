"""Robust homography between matched points: the stand-in for
``cv2.findHomography(points_i, points_j, cv2.USAC_MAGSAC)`` at its defaults
(3 px, 2000 iterations, confidence 0.995), which ``hive_tpu``'s feature
extractor uses as its geometric filter (``hive_tpu/pose_optimisation.py:393``).

All hypotheses at once on the device: 2000 four-point samples drawn from an
explicit ``torch.Generator``, each solved by the normalised direct linear
transform (the null vector of its 8x9 system, from one batched ``eigh`` of
the 9x9 normal matrices), then all scored in one pass over the (hypotheses,
points) forward transfer errors. The score is MSAC's truncated quadratic,
``sum(min(e^2, t^2))``, not MAGSAC++'s marginalisation over noise scales:
a simpler score with the same inlier threshold. The best hypothesis is then
optimised locally (least squares on its inliers, repeated while its score
improves), and the inlier mask is the points within 3 px of that model.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

THRESHOLD = 3.0
MAX_ITERS = 2000
LOCAL_STEPS = 10
SAMPLE_SIZE = 4


def _normaliser(points: torch.Tensor) -> torch.Tensor:
    """Hartley's similarity: centroid to the origin, mean distance sqrt(2)."""
    centre = points.mean(dim=0)
    scale = (2.0 ** 0.5) / torch.clamp((points - centre).norm(dim=1).mean(), min=1e-12)
    T = torch.zeros((3, 3), dtype=points.dtype, device=points.device)
    T[0, 0] = T[1, 1] = scale
    T[0, 2], T[1, 2] = -scale * centre[0], -scale * centre[1]
    T[2, 2] = 1.0
    return T


def _apply(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    return points @ T[:2, :2].T + T[:2, 2]


def _dlt(src: torch.Tensor, dst: torch.Tensor, weight: Optional[torch.Tensor] = None):
    """Homographies from batches of correspondences (B, M, 2) by the null
    vector of the DLT system; ``weight`` (B, M) selects points (0 / 1)."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], dim=-1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    if weight is not None:
        r1, r2 = r1 * weight[..., None], r2 * weight[..., None]
    A = torch.cat([r1, r2], dim=-2)
    _, vectors = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return vectors[..., 0].reshape(*src.shape[:-2], 3, 3)


def transfer_errors(H: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Squared forward transfer errors |H src - dst|^2 of (B, 3, 3)
    homographies over (N, 2) points: (B, N)."""
    p = src @ H[..., :2, :2].transpose(-1, -2) + H[..., None, :2, 2]
    w = src @ H[..., 2:3, :2].transpose(-1, -2) + H[..., None, 2:3, 2]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return ((p / w - dst) ** 2).sum(dim=-1)


def find_homography(src: torch.Tensor, dst: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The homography taking ``src`` to ``dst`` and its inlier mask.

    :param src, dst: (N, 2) matched points on one device.
    :param generator: the random source of the samples (on the points'
        device); a fresh one seeded with 0 by default.
    :return: (3, 3) float64 H with H[2, 2] = 1 and the (N,) bool mask, or
        ``(None, None)`` where no model reaches four inliers.
    """
    device = src.device
    n = src.shape[0]
    if n < SAMPLE_SIZE:
        return None, None
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    limit = THRESHOLD * THRESHOLD
    src64, dst64 = src.double(), dst.double()
    Ts, Td = _normaliser(src64), _normaliser(dst64)
    ns, nd = _apply(Ts, src64), _apply(Td, dst64)
    Td_inv = torch.linalg.inv(Td)

    def denormalise(Hn):
        return Td_inv @ Hn @ Ts

    def score(errors):
        return torch.clamp(errors, max=limit).sum(dim=-1)

    samples = torch.rand((MAX_ITERS, n), generator=generator, device=device).topk(
        SAMPLE_SIZE, dim=1).indices
    hypotheses = denormalise(_dlt(ns[samples], nd[samples]))
    errors = transfer_errors(hypotheses, src64, dst64)
    costs = score(errors)
    best = torch.argmin(costs)
    H, cost = hypotheses[best], costs[best]
    inliers = errors[best] < limit

    # Local optimisation: refit on the inliers while the score improves.
    for _ in range(LOCAL_STEPS):
        candidate = denormalise(_dlt(ns[None], nd[None], inliers[None].double())[0])
        e = transfer_errors(candidate[None], src64, dst64)[0]
        c = score(e)
        better = c < cost
        H = torch.where(better, candidate, H)
        cost = torch.where(better, c, cost)
        inliers = torch.where(better, e < limit, inliers)

    if int(inliers.sum()) < SAMPLE_SIZE:
        return None, None
    return H / H[2, 2], inliers
