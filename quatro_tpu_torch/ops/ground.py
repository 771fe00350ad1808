"""The ground-plane leveling of clouds as one kernel.

The JAX package runs ``align_ground`` as one ``jax.jit``
(``quatro_tpu/solver/ground.py:53-146``; no Pallas kernel there): XLA
fuses the masked centroid, the 3x3 scatter, the closed-form eigenpair,
the gates and the leveling rotation. The port runs the fit, the gates and
the rotation of every cloud as one launch (``solver/ground.py`` calls
it):

- ``ground_fit``: clouds (..., N, 3) with ground masks -> each cloud's
  gated leveling rotation (C, 3, 3), leveled ground height (C,) and gate
  (C,) (csrc/ground.cu, a thread-block cluster of 8 CTAs a cloud, no
  host read). Both sums of the fit go over N in ``fused.pairwise_sum``'s
  tree: a thread folds the tree's top levels over its strided points, a
  CTA the next ten, the cluster the last three through distributed shared
  memory. With a second set of clouds (align_ground: the sources, then
  the targets) cloud c and its partner level only where both fits pass,
  gated on the card by the pair's second cluster to finish.

For CUDA tensors the wrapper checks its inputs, launches on the current
stream and counts the launch in ``LAUNCHES``; for CPU tensors it runs its
plain version ``ground_fit_plain`` (``fit_ground_plane``,
``leveling_rotation`` and the gates: the torch code the leveling ran
before). There is no fallback between the two, and the kernel equals its
plain version on the card bit for bit: every operation rounds once as its
torch operation does there. Two reductions whose order torch chooses by
the shape are written in one order here: |n| as
``sqrt(fma(n_z, n_z, fma(n_y, n_y, n_x n_x)))`` (torch.linalg.vector_norm's
order on the CPU) and the height as ``(l20 c0 + l21 c1) + l22 c2`` (the
CPU's sum of three). Past 2^18 points a cloud the kernel raises
ValueError.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from quatro_tpu_torch.ops.launch import (LAUNCHES, check, launch, same_device,
                                         size_route, stream_scratch)
from quatro_tpu_torch.ops.normals import smallest_eigenvector_3x3
from quatro_tpu_torch.utils.fused import f32, fma, pairwise_sum, sqrt
from quatro_tpu_torch.utils.se3 import rotate_points

# points a cloud of the kernel's register fold (2^5 points a thread of a
# cloud's 8192); larger clouds take its wide route (tree.cuh's strided fold)
GROUND_MAX_POINTS = 1 << 18


class GroundPlane(NamedTuple):
    normal: torch.Tensor    # (3,) unit, oriented n_z > 0
    centroid: torch.Tensor  # (3,)
    count: torch.Tensor     # () int32: ground points used
    flatness: torch.Tensor  # () f32: lambda_min / trace (0 = perfect plane)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of (..., 3, 3) matrices in full f32."""
    return rotate_points(a, b.transpose(-1, -2))


def fit_ground_plane(points: torch.Tensor, mask: torch.Tensor) -> GroundPlane:
    """Least-squares plane through the masked points: masked centroid,
    3x3 scatter matrix (true f32 products summed in one fixed order,
    ``pairwise_sum``, so a cloud of a batch gives its own bits; never
    TF32), smallest eigenvector as the normal, oriented upward."""
    w = mask.to(points.dtype)
    count = mask.sum(-1).to(torch.int32)
    denom = torch.clamp(w.sum(-1), min=1.0)
    centroid = pairwise_sum(points * w[..., None], -2) / denom[..., None]
    d = (points - centroid[..., None, :]) * w[..., None]
    cov = (pairwise_sum(d[..., :, None] * d[..., None, :], -3)
           / denom[..., None, None])
    normal, lam_min = smallest_eigenvector_3x3(cov)
    normal = normal * torch.sign(normal[..., 2:3] + 1e-12)
    trace = cov[..., 0, 0] + cov[..., 1, 1] + cov[..., 2, 2]
    flatness = lam_min / torch.clamp(trace, min=1e-30)
    return GroundPlane(normal, centroid, count, flatness)


def leveling_rotation(normal: torch.Tensor) -> torch.Tensor:
    """Minimal rotation taking ``normal`` to +z (Rodrigues, closed form):
    with v = n x z and c = n.z, R = I + [v]x + [v]x^2 / (1 + c). |n| is
    sqrt(fma(n_z, n_z, fma(n_y, n_y, n_x n_x))), the order in which
    torch.linalg.vector_norm adds it on the CPU, written out so that the
    card adds it so too."""
    nx, ny, nz = normal.unbind(-1)
    length = sqrt(fma(nz, nz, fma(ny, ny, nx * nx)))[..., None]
    n = normal / torch.clamp(length, min=1e-12)
    vx, vy, c = n[..., 1], -n[..., 0], n[..., 2]
    k = 1.0 / torch.clamp(1.0 + c, min=1e-6)
    z = torch.zeros_like(c)
    hat = torch.stack([torch.stack([z, z, vy], -1),
                       torch.stack([z, z, -vx], -1),
                       torch.stack([-vy, vx, z], -1)], -2)
    eye = torch.eye(3, dtype=normal.dtype, device=normal.device)
    return eye + hat + k[..., None, None] * _matmul3(hat, hat)


def _gates(config):
    """The gates' constants as the JAX package rounds them: (min_points,
    f32 cos of the f32 tilt, f32 flatness)."""
    return (int(config.min_points),
            f32(math.cos(f32(math.radians(config.max_tilt_deg)))),
            f32(config.max_flatness))


def gated_leveling(plane: GroundPlane, config):
    """(L, height, ok): identity leveling where the fit fails the gates
    (count, tilt, flatness); the height (l20 c0 + l21 c1) + l22 c2, the
    CPU's order of the sum of three, written out."""
    min_points, min_cos, max_flat = _gates(config)
    ok = ((plane.count >= min_points)
          & (plane.normal[..., 2] >= min_cos)
          & (plane.flatness <= max_flat))
    eye = torch.eye(3, dtype=plane.normal.dtype, device=plane.normal.device)
    level = torch.where(ok[..., None, None], leveling_rotation(plane.normal),
                        eye)
    p = level[..., 2, :] * plane.centroid
    height = torch.where(ok, (p[..., 0] + p[..., 1]) + p[..., 2], 0.0)
    return level, height, ok


def ground_fit_plain(points, mask, config, other=None):
    """``ground_fit`` in torch operations: ``fit_ground_plane`` and
    ``gated_leveling`` of each set, and with ``other`` the pair's gate
    (both fits pass, else identity and zero heights)."""
    sets = [(points, mask)] + ([other] if other is not None else [])
    out = []
    for p, m in sets:
        lv, h, ok = gated_leveling(fit_ground_plane(p, m), config)
        out.append((lv.reshape(-1, 3, 3), h.reshape(-1), ok.reshape(-1)))
    if other is not None:
        (la, ha, oka), (lb, hb, okb) = out
        ok = oka & okb
        eye = torch.eye(3, dtype=la.dtype, device=la.device)
        okm = ok[..., None, None]
        out = [(torch.where(okm, la, eye), torch.where(ok, ha, 0.0), ok),
               (torch.where(okm, lb, eye), torch.where(ok, hb, 0.0), ok)]
    return tuple(torch.cat(parts) for parts in zip(*out))


def ground_fit(points, mask, config, other=None):
    """The gated leveling of clouds (..., N, 3) with ground masks (...,
    N): (level (C, 3, 3), height (C,), ok (C,)), flattened. With ``other``
    = (points, mask) of the same shape of lead (align_ground: the sources,
    then the targets) the i-th clouds of the two sets are a pair that
    levels only where both fits pass, ok the pair's, and the C clouds are
    both sets'. For CUDA tensors one launch of csrc/ground.cu (a cluster
    a cloud; past GROUND_MAX_POINTS points its wide route, counted in
    ``SIZE_ROUTES``), bit for bit
    ``ground_fit_plain``, which runs for CPU tensors."""
    sets = [(points, mask)] + ([tuple(other)] if other is not None else [])
    if same_device(*(t for s in sets for t in s)).type != "cuda":
        return ground_fit_plain(points, mask, config, other)
    if other is not None and other[0].shape[:-2] != points.shape[:-2]:
        raise ValueError("ground_fit: the two sets of clouds differ in "
                         "their shape of lead")
    shapes = []
    for p, m in sets:
        c, n = p[..., 0, 0].numel(), p.shape[-2]
        check("points", p, (*p.shape[:-2], n, 3))
        check("mask", m, (*p.shape[:-2], n), torch.bool)
        shapes.append((c, n))
    (ca, na), (cb, nb) = shapes[0], (shapes[1] if other is not None
                                     else (0, 0))
    dev = points.device
    level = torch.empty((ca + cb, 3, 3), dtype=torch.float32, device=dev)
    height = torch.empty((ca + cb,), dtype=torch.float32, device=dev)
    ok = torch.empty((ca + cb,), dtype=torch.bool, device=dev)
    if ca + cb:
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = stream_scratch(dev, stream, ca, 0)[0] if cb else 0
        min_points, min_cos, max_flat = _gates(config)
        pb, mb = sets[1] if other is not None else (0, 0)
        launch("ground", points, mask, ca, na, pb, mb, cb, nb, int(cb > 0),
               min_points, min_cos, max_flat, tickets, level, height, ok,
               stream=stream)
        LAUNCHES["ground_fit"] += 1
        size_route("ground_fit", max(na, nb) > GROUND_MAX_POINTS)
    return level, height, ok
