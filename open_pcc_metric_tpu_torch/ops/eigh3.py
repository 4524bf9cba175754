"""Closed-form batched symmetric 3x3 eigendecomposition (smallest eigenvector).

Port of ``open_pcc_metric_tpu/ops/eigh3.py``: the trigonometric eigenvalue
formula plus a Cayley-Hamilton eigenvector extraction, written elementwise
on the six symmetric components in the JAX package's operation order. No
``torch.linalg.eigh`` and no matmul (a TF32 product would tilt the normals;
see ``ops/normals.py``).
"""
from __future__ import annotations

import math

import torch


def _div(x: torch.Tensor, y: float) -> torch.Tensor:
    """x / y as a true division (torch may turn a tensor-by-Python-scalar
    division into a product with the reciprocal)."""
    return x / torch.tensor(y, dtype=x.dtype, device=x.device)


def smallest_eigenvector_components(a00, a11, a22, a01, a02, a12):
    """Smallest-eigenvalue unit eigenvector from symmetric components.

    Args:
      a00..a12: (...,) tensors, the six unique entries of symmetric matrices.
    Returns:
      (..., 3) unit vectors. Degenerate (near-isotropic or near-zero) inputs
      return (0, 0, 1), mirroring Open3D's FastEigen3x3 fallback.
    """
    eps = torch.finfo(a00.dtype).eps
    one = torch.ones_like(a00)

    scale = torch.maximum(
        torch.maximum(torch.maximum(a00.abs(), a11.abs()),
                      torch.maximum(a22.abs(), a01.abs())),
        torch.maximum(a02.abs(), a12.abs()),
    )
    ok_scale = scale > 0
    inv = torch.where(ok_scale, one / torch.where(ok_scale, scale, one), one)
    a00, a11, a22 = a00 * inv, a11 * inv, a22 * inv
    a01, a02, a12 = a01 * inv, a02 * inv, a12 * inv

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = _div(a00 + a11 + a22, 3.0)
    e0, e1, e2 = a00 - q, a11 - q, a22 - q
    p2 = e0 * e0 + e1 * e1 + e2 * e2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(_div(p2, 6.0), min=0.0))
    safe_p = torch.where(p > eps, p, one)

    B00 = e0 / safe_p
    B11 = e1 / safe_p
    B22 = e2 / safe_p
    B01 = a01 / safe_p
    B02 = a02 / safe_p
    B12 = a12 / safe_p
    detB = (
        B00 * (B11 * B22 - B12 * B12)
        - B01 * (B01 * B22 - B12 * B02)
        + B02 * (B01 * B12 - B11 * B02)
    )
    r = torch.clamp(_div(detB, 2.0), -1.0, 1.0)
    phi = _div(torch.arccos(r), 3.0)
    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min

    # Cayley-Hamilton: columns of C = (A - lam_max I)(A - lam_mid I) span
    # the lam_min eigenspace, written out per component.
    m100, m111, m122 = a00 - lam_max, a11 - lam_max, a22 - lam_max
    m200, m211, m222 = a00 - lam_mid, a11 - lam_mid, a22 - lam_mid
    C00 = m100 * m200 + a01 * a01 + a02 * a02
    C10 = a01 * m200 + m111 * a01 + a12 * a02
    C20 = a02 * m200 + a12 * a01 + m122 * a02
    C01 = m100 * a01 + a01 * m211 + a02 * a12
    C11 = a01 * a01 + m111 * m211 + a12 * a12
    C21 = a02 * a01 + a12 * m211 + m122 * a12
    C02 = m100 * a02 + a01 * a12 + a02 * m222
    C12 = a01 * a02 + m111 * a12 + a12 * m222
    C22 = a02 * a02 + a12 * a12 + m122 * m222

    # The largest column (argmax semantics: the first max wins).
    n0 = C00 * C00 + C10 * C10 + C20 * C20
    n1 = C01 * C01 + C11 * C11 + C21 * C21
    n2 = C02 * C02 + C12 * C12 + C22 * C22
    use1 = n1 > n0
    use2 = n2 > torch.maximum(n0, n1)
    vx = torch.where(use2, C02, torch.where(use1, C01, C00))
    vy = torch.where(use2, C12, torch.where(use1, C11, C10))
    vz = torch.where(use2, C22, torch.where(use1, C21, C20))
    vnorm = torch.sqrt(vx * vx + vy * vy + vz * vz)

    good = (p > 16 * eps) & (vnorm > math.sqrt(eps)) & ok_scale
    safe_n = torch.where(vnorm > 0, vnorm, one)
    zero = torch.zeros_like(vx)
    vx = torch.where(good, vx / safe_n, zero)
    vy = torch.where(good, vy / safe_n, zero)
    vz = torch.where(good, vz / safe_n, one)
    return torch.stack([vx, vy, vz], dim=-1)


def smallest_eigenvector_sym3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue for a batch of symmetric
    (..., 3, 3) matrices (see ``smallest_eigenvector_components``)."""
    return smallest_eigenvector_components(
        A[..., 0, 0], A[..., 1, 1], A[..., 2, 2],
        A[..., 0, 1], A[..., 0, 2], A[..., 1, 2],
    )
