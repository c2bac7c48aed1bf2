"""Camera pose from 3-D to 2-D correspondences: RANSAC PnP, then
Levenberg-Marquardt refinement, and Rodrigues' formula both ways.

The stand-in for what ``hive_tpu``'s odometry calls
(``hive_tpu/sfm.py:143-160``): ``cv2.solvePnPRansac(..., reprojectionError=4,
iterationsCount=200, flags=SOLVEPNP_ITERATIVE)``, then ``cv2.solvePnP(...,
useExtrinsicGuess=True, flags=SOLVEPNP_ITERATIVE)`` on its inliers and
``cv2.Rodrigues``. OpenCV's RANSAC kernel for the ITERATIVE flag is EPnP on
five points; here all 200 five-point EPnP solves run as one batch on the
device (OpenCV stops early once its confidence is reached, so it tries at
most as many), a hypothesis' inliers are the points it reprojects within
the threshold (squared error <= threshold^2), the one with the most wins,
and OpenCV's refinement follows: Levenberg-Marquardt on the reprojection
error of the inliers over (rvec, tvec), in float64, with OpenCV's
``CvLevMarq`` damping (the Hessian's diagonal scaled by 1 + lambda, lambda
starting at 1e-3, divided by 10 after a step that lowers the error and
multiplied by 10 otherwise), 20 steps without a host round trip.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

RANSAC_ITERATIONS = 200
SAMPLE_SIZE = 5
LM_STEPS = 20

_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


# ---------------------------------------------------------------------------
# Rodrigues.
# ---------------------------------------------------------------------------

def _skew(v: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([zero, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], zero, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], zero], -1)], -2)


def rodrigues_to_matrix(rvec: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vectors to (..., 3, 3) matrices (``cv2.Rodrigues``),
    as ``I + a [r]x + b [r]x^2`` with ``a = sin(t) / t`` and ``b = (1 -
    cos(t)) / t^2``, their series near t = 0 (differentiable everywhere)."""
    theta2 = (rvec * rvec).sum(dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-30))
    small = theta2 < 1e-12
    a = torch.where(small, 1 - theta2 / 6, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24, (1 - torch.cos(theta)) / torch.clamp(theta2, min=1e-30))
    K = _skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def matrix_to_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """A (3, 3) rotation matrix to its rotation vector, as ``cv2.Rodrigues``
    computes it: the nearest rotation first, the angle from the trace, the
    axis from the skew part, or from the diagonal near pi."""
    U, _, Vh = torch.linalg.svd(R.double())
    R = U @ Vh
    r = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = float(torch.sqrt((r * r).sum() * 0.25))
    c = min(max(float((R.trace() - 1) * 0.5), -1.0), 1.0)
    theta = math.acos(c)
    if s >= 1e-5:
        return r * (theta / (2 * s))
    if c > 0:
        return torch.zeros(3, dtype=R.dtype, device=R.device)
    m = R.cpu().tolist()
    rx = math.sqrt(max((m[0][0] + 1) * 0.5, 0.0))
    ry = math.sqrt(max((m[1][1] + 1) * 0.5, 0.0)) * (-1.0 if m[0][1] < 0 else 1.0)
    rz = math.sqrt(max((m[2][2] + 1) * 0.5, 0.0)) * (-1.0 if m[0][2] < 0 else 1.0)
    if abs(rx) < abs(ry) and abs(rx) < abs(rz) and (m[1][2] > 0) != (ry * rz > 0):
        rz = -rz
    theta /= math.sqrt(rx * rx + ry * ry + rz * rz)
    return torch.tensor([rx * theta, ry * theta, rz * theta], dtype=R.dtype, device=R.device)


# ---------------------------------------------------------------------------
# EPnP (batched).
# ---------------------------------------------------------------------------

def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched least squares by the pseudo-inverse (SVD), as OpenCV's
    ``cvSolve(..., CV_SVD)``."""
    return (torch.linalg.pinv(A) @ b[..., None])[..., 0]


def epnp(object_points: torch.Tensor, image_points: torch.Tensor,
         K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """EPnP (OpenCV's ``epnp.cpp``) for a batch of point sets.

    :param object_points: (B, n, 3) float64.
    :param image_points: (B, n, 2) float64 pixels.
    :param K: (3, 3) intrinsics.
    :return: R (B, 3, 3) and t (B, 3), world to camera.
    """
    fu, fv, uc, vc = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    B, n, _ = object_points.shape
    pws = object_points

    # Control points: the centroid and the principal directions.
    c0 = pws.mean(dim=1)
    centred = pws - c0[:, None]
    U, dc, _ = torch.linalg.svd(centred.transpose(1, 2) @ centred)
    k = torch.sqrt(dc / n)
    cws = torch.cat([c0[:, None], c0[:, None] + k[..., None] * U.transpose(1, 2)], dim=1)

    # Barycentric coordinates.
    CC = (cws[:, 1:] - cws[:, :1]).transpose(1, 2)
    a123 = (torch.linalg.pinv(CC) @ centred.transpose(1, 2)).transpose(1, 2)
    alphas = torch.cat([1 - a123.sum(dim=2, keepdim=True), a123], dim=2)   # (B, n, 4)

    u, v = image_points[..., 0:1], image_points[..., 1:2]
    zero = torch.zeros_like(alphas)
    M1 = torch.stack([alphas * fu, zero, alphas * (uc - u)], dim=3).reshape(B, n, 12)
    M2 = torch.stack([zero, alphas * fv, alphas * (vc - v)], dim=3).reshape(B, n, 12)
    M = torch.cat([M1, M2], dim=1)
    _, vectors = torch.linalg.eigh(M.transpose(1, 2) @ M)
    null = vectors[..., :4].transpose(1, 2)          # (B, 4, 12), smallest first

    # L (B, 6, 10) and rho (B, 6).
    v4 = null.reshape(B, 4, 4, 3)
    dv = torch.stack([v4[:, :, a] - v4[:, :, b] for a, b in _PAIRS], dim=2)   # (B, 4, 6, 3)

    def dot(i, j):
        return (dv[:, i] * dv[:, j]).sum(dim=-1)

    L = torch.stack([dot(0, 0), 2 * dot(0, 1), dot(1, 1), 2 * dot(0, 2), 2 * dot(1, 2),
                     dot(2, 2), 2 * dot(0, 3), 2 * dot(1, 3), 2 * dot(2, 3), dot(3, 3)], dim=2)
    rho = torch.stack([((cws[:, a] - cws[:, b]) ** 2).sum(dim=-1) for a, b in _PAIRS], dim=1)

    def betas_1():
        b4 = _lstsq(L[..., [0, 1, 3, 6]], rho)
        sign = torch.where(b4[:, :1] < 0, -1.0, 1.0).to(b4.dtype)
        root = torch.sqrt(torch.abs(b4[:, :1]))
        safe = torch.where(root == 0, torch.ones_like(root), root)
        return torch.cat([root, sign * b4[:, 1:] / safe], dim=1)

    def betas_2():
        b3 = _lstsq(L[..., [0, 1, 2]], rho)
        neg = b3[:, 0] < 0
        b0 = torch.sqrt(torch.abs(b3[:, 0]))
        b1 = torch.where(neg, torch.sqrt(torch.clamp(-b3[:, 2], min=0)),
                         torch.sqrt(torch.clamp(b3[:, 2], min=0)))
        b0 = torch.where(b3[:, 1] < 0, -b0, b0)
        zero = torch.zeros_like(b0)
        return torch.stack([b0, b1, zero, zero], dim=1)

    def betas_3():
        b5 = _lstsq(L[..., [0, 1, 2, 3, 4]], rho)
        neg = b5[:, 0] < 0
        b0 = torch.sqrt(torch.abs(b5[:, 0]))
        b1 = torch.where(neg, torch.sqrt(torch.clamp(-b5[:, 2], min=0)),
                         torch.sqrt(torch.clamp(b5[:, 2], min=0)))
        b0 = torch.where(b5[:, 1] < 0, -b0, b0)
        safe = torch.where(b0 == 0, torch.ones_like(b0), b0)
        return torch.stack([b0, b1, b5[:, 3] / safe, torch.zeros_like(b0)], dim=1)

    def gauss_newton(betas):
        for _ in range(5):
            b0, b1, b2, b3 = betas.unbind(1)
            l = L.unbind(2)
            A = torch.stack([
                2 * l[0] * b0[:, None] + l[1] * b1[:, None] + l[3] * b2[:, None] + l[6] * b3[:, None],
                l[1] * b0[:, None] + 2 * l[2] * b1[:, None] + l[4] * b2[:, None] + l[7] * b3[:, None],
                l[3] * b0[:, None] + l[4] * b1[:, None] + 2 * l[5] * b2[:, None] + l[8] * b3[:, None],
                l[6] * b0[:, None] + l[7] * b1[:, None] + l[8] * b2[:, None] + 2 * l[9] * b3[:, None],
            ], dim=2)
            quad = torch.stack([b0 * b0, b0 * b1, b1 * b1, b0 * b2, b1 * b2, b2 * b2, b0 * b3,
                                b1 * b3, b2 * b3, b3 * b3], dim=1)
            b = rho - (L * quad[:, None]).sum(dim=2)
            betas = betas + _lstsq(A, b)
        return betas

    def pose(betas):
        # The null vectors are ordered smallest first, OpenCV's v[0] first.
        ccs = (betas[..., None] * null).sum(dim=1).reshape(B, 4, 3)
        pcs = alphas @ ccs
        flip = pcs[:, :1, 2:3] < 0
        pcs = torch.where(flip, -pcs, pcs)
        pc0, pw0 = pcs.mean(dim=1), pws.mean(dim=1)
        abt = (pcs - pc0[:, None]).transpose(1, 2) @ (pws - pw0[:, None])
        Ua, _, Vha = torch.linalg.svd(abt)
        R = Ua @ Vha
        det = torch.linalg.det(R)
        R = torch.where((det < 0)[:, None, None],
                        torch.cat([R[:, :2], -R[:, 2:]], dim=1), R)
        t = pc0 - (R @ pw0[..., None])[..., 0]
        err = reprojection_errors(R, t, pws, image_points, K).sqrt().mean(dim=1)
        return R, t, err

    candidates = [pose(gauss_newton(b())) for b in (betas_1, betas_2, betas_3)]
    errs = torch.stack([c[2] for c in candidates], dim=1)
    errs = torch.where(torch.isnan(errs), torch.full_like(errs, float("inf")), errs)
    best = torch.argmin(errs, dim=1)
    R = torch.stack([c[0] for c in candidates], dim=1)[torch.arange(B), best]
    t = torch.stack([c[1] for c in candidates], dim=1)[torch.arange(B), best]
    return R, t


def project(R: torch.Tensor, t: torch.Tensor, points: torch.Tensor,
            K: torch.Tensor) -> torch.Tensor:
    """Pixels of (n, 3) or (B, n, 3) world points under (B?, 3, 3) R, t."""
    cam = points @ R.transpose(-1, -2) + t[..., None, :]
    z = cam[..., 2]
    return torch.stack([K[0, 0] * cam[..., 0] / z + K[0, 2],
                        K[1, 1] * cam[..., 1] / z + K[1, 2]], dim=-1)


def reprojection_errors(R, t, points, pixels, K) -> torch.Tensor:
    """Squared reprojection errors."""
    return ((project(R, t, points, K) - pixels) ** 2).sum(dim=-1)


# ---------------------------------------------------------------------------
# Levenberg-Marquardt and RANSAC.
# ---------------------------------------------------------------------------

def refine_pose(object_points: torch.Tensor, image_points: torch.Tensor, K: torch.Tensor,
                rvec: torch.Tensor, tvec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cv2.solvePnP(..., useExtrinsicGuess=True, flags=SOLVEPNP_ITERATIVE)``:
    Levenberg-Marquardt from (rvec, tvec) on the reprojection error."""
    def residuals(p):
        """Residuals (..., 2N) of a batch of (..., 6) parameters."""
        R = rodrigues_to_matrix(p[..., :3])
        pixels = project(R, p[..., 3:], object_points, K)
        return (pixels - image_points).reshape(*p.shape[:-1], -1)

    params = torch.cat([rvec, tvec]).double()
    # The residuals and their central differences in all six directions,
    # one batched evaluation: row 0 the point, rows 1-12 the probes.
    h = 1e-7
    offsets = torch.cat([torch.zeros((1, 6)), torch.eye(6) * h, torch.eye(6) * -h]).to(params)

    def evaluate(p):
        rows = residuals(p + offsets)
        return rows[0], ((rows[1:7] - rows[7:]) / (2 * h)).T

    lam = torch.tensor(1e-3, dtype=torch.float64, device=params.device)
    r, J = evaluate(params)
    err = (r * r).sum()
    for _ in range(LM_STEPS):
        JtJ = J.T @ J
        damped = JtJ + torch.diag(torch.diagonal(JtJ) * lam)
        candidate = params - torch.linalg.solve_ex(damped, J.T @ r)[0]
        rc, Jc = evaluate(candidate)
        err_c = (rc * rc).sum()
        better = err_c < err
        params = torch.where(better, candidate, params)
        r, J = torch.where(better, rc, r), torch.where(better, Jc, J)
        err = torch.where(better, err_c, err)
        lam = torch.where(better, torch.clamp(lam / 10, min=1e-16), torch.clamp(lam * 10, max=1e16))
    return params[:3], params[3:]


def solve_pnp_ransac(object_points: torch.Tensor, image_points: torch.Tensor, K: torch.Tensor,
                     reprojection_error: float = 4.0,
                     generator: Optional[torch.Generator] = None):
    """``cv2.solvePnPRansac`` with ``SOLVEPNP_ITERATIVE``: batched EPnP
    hypotheses, the most inliers, then the refinement on them.

    :param object_points: (N, 3), :param image_points: (N, 2), :param K:
        (3, 3), all float64 on one device.
    :return: ``(ok, rvec, tvec, inliers)``: the (3,) vectors and the inlier
        indices (M,), or ``(False, None, None, None)``.
    """
    device = object_points.device
    n = object_points.shape[0]
    if n < SAMPLE_SIZE:
        return False, None, None, None
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    samples = torch.rand((RANSAC_ITERATIONS, n), generator=generator, device=device).topk(
        SAMPLE_SIZE, dim=1).indices
    R, t = epnp(object_points[samples], image_points[samples], K)
    errors = reprojection_errors(R, t, object_points[None], image_points[None], K)
    inlier_mask = errors <= reprojection_error * reprojection_error
    counts = torch.where(torch.isnan(errors), torch.zeros_like(errors), inlier_mask.double()).sum(1)
    best = torch.argmax(counts)
    inliers = torch.nonzero(inlier_mask[best] & ~torch.isnan(errors[best]))[:, 0]
    if len(inliers) < SAMPLE_SIZE:
        return False, None, None, None
    rvec, tvec = refine_pose(object_points[inliers], image_points[inliers], K,
                             matrix_to_rodrigues(R[best]), t[best])
    return True, rvec, tvec, inliers
