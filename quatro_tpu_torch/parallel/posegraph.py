"""Pose-graph loop closing over registered scan pairs.

PyTorch counterpart of ``quatro_tpu/parallel/posegraph.py``: given relative
4-DoF measurements (3-D translation and yaw, Quatro's output space) along a
trajectory plus loop-closure edges, solve for globally consistent poses
(M, 4) = (x, y, z, yaw).

Gauss-Newton where each linearised step solves the normal equations
J^T W J delta = -J^T W r by matrix-free conjugate gradients: edge-wise
gathers, dense per-edge algebra, and a segment sum back to the poses. The
trip counts are fixed (``gn_iters`` x ``cg_iters``) and nothing is read
back to the host inside the loops, which on the card replay a CUDA graph
per Gauss-Newton iteration. The scatter J^T u goes through the
port's segment sums (ops/segment.py, B2 on the card), which add in a fixed
order with no float atomics, so a second solve of the same graph on the
card gives the same bits. Gauge freedom is fixed by projecting pose 0's
update out of the CG solve exactly.

With the edges sharded over the ranks of a process group (parallel/
sharding.py), each rank sums its own edges' J^T terms and ``psum_axis``
all-reduces the (M, 4) result: the only collective of the design, one per
J^T apply, gn_iters x (cg_iters + 1) per solve. Everything else, the inner
products of CG included, is the same on every rank after it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from quatro_tpu_torch.ops.segment import segment_sums
from quatro_tpu_torch.parallel.mesh import all_reduce_sum, axis_group
from quatro_tpu_torch.utils import loops


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor         # (E,) int32 source pose index
    j: torch.Tensor         # (E,) int32 target pose index
    t_meas: torch.Tensor    # (E, 3) measured t_ij = R(-yaw_i)(t_j - t_i)
    yaw_meas: torch.Tensor  # (E,) measured relative yaw
    weight: torch.Tensor    # (E,) edge confidence (e.g. final inlier count)
    mask: torch.Tensor      # (E,) bool


def wrap_angle(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def solution_to_edge(sol_translation, sol_rotation):
    """A solution (tgt = R src + t, src -> tgt in the target frame) as the
    edge measurement used here: (translation, yaw)."""
    yaw = torch.atan2(sol_rotation[..., 1, 0], sol_rotation[..., 0, 0])
    return sol_translation, yaw


def _ends(poses, edges: PoseGraphEdges):
    """(pose i, pose j, cos yaw_i, sin yaw_i, t_j - t_i) per edge."""
    pi = poses[edges.i.long()]
    pj = poses[edges.j.long()]
    yaw_i = pi[:, 3]
    return pi, pj, torch.cos(yaw_i), torch.sin(yaw_i), pj[:, :3] - pi[:, :3]


def _dyaw_term(c, s, dt):
    """d/dyaw_i of R(-yaw_i) dt."""
    return torch.stack([-s * dt[:, 0] + c * dt[:, 1],
                        -c * dt[:, 0] - s * dt[:, 1],
                        torch.zeros_like(s)], dim=-1)


def _edge_residuals(poses, edges: PoseGraphEdges):
    """r_t (E, 3), r_yaw (E,) for the current pose estimates."""
    pi, pj, c, s, dt = _ends(poses, edges)
    local = torch.stack([c * dt[:, 0] + s * dt[:, 1],
                         -s * dt[:, 0] + c * dt[:, 1],
                         dt[:, 2]], dim=-1)               # R(-yaw_i) dt
    r_t = local - edges.t_meas
    r_yaw = wrap_angle(pj[:, 3] - pi[:, 3] - edges.yaw_meas)
    return r_t, r_yaw


def _edge_jacobian_apply(poses, edges: PoseGraphEdges, v):
    """J @ v for a pose-space vector v (M, 4) -> per edge (E, 4)."""
    _, _, c, s, dt = _ends(poses, edges)
    vi = v[edges.i.long()]
    vj = v[edges.j.long()]
    dvt = vj[:, :3] - vi[:, :3]
    jt = torch.stack([c * dvt[:, 0] + s * dvt[:, 1],
                      -s * dvt[:, 0] + c * dvt[:, 1],
                      dvt[:, 2]], dim=-1) + _dyaw_term(c, s, dt) * vi[:, 3:4]
    jyaw = vj[:, 3] - vi[:, 3]
    return torch.cat([jt, jyaw[:, None]], dim=-1)


def _edge_jacobian_transpose_apply(poses, edges: PoseGraphEdges, u,
                                   num_poses: int, psum_axis=None):
    """J^T @ u for a per-edge residual-space u (E, 4) -> pose space (M, 4):
    the i and j contributions as one segment sum, in edge order, then
    summed over the ranks of ``psum_axis``. The all-reduce runs in place
    on the segment sum's output, a fresh tensor (never a view into B2's
    per-stream scratch, which holds only its partials), after B2 on the
    same stream."""
    _, _, c, s, dt = _ends(poses, edges)
    ut, uy = u[:, :3], u[:, 3]
    # R(-yaw_i)^T ut, with the sign - for pose i and + for pose j
    rt_ut = torch.stack([c * ut[:, 0] - s * ut[:, 1],
                         s * ut[:, 0] + c * ut[:, 1],
                         ut[:, 2]], dim=-1)
    gi_yaw = (_dyaw_term(c, s, dt) * ut).sum(-1) - uy
    gi = torch.cat([-rt_ut, gi_yaw[:, None]], dim=-1)
    gj = torch.cat([rt_ut, uy[:, None]], dim=-1)
    ids = torch.cat([edges.i, edges.j]).to(torch.int32).contiguous()
    vals = torch.cat([gi, gj]).T.contiguous()
    return all_reduce_sum(segment_sums(ids, vals, num_poses), psum_axis)


def _zero_first(x):
    """x with row 0 set to 0 (pose 0 fixes the gauge)."""
    return torch.cat([torch.zeros_like(x[:1]), x[1:]])


def _gn_step(edges: PoseGraphEdges, w_edge, poses, num_poses: int,
             cg_iters: int, damping: float, psum_axis):
    """One Gauss-Newton iteration: the damped normal equations solved by
    ``cg_iters`` CG steps, the update applied and the yaws wrapped."""

    def normal_matvec(v):
        jv = _edge_jacobian_apply(poses, edges, _zero_first(v))
        jtwjv = _edge_jacobian_transpose_apply(poses, edges, jv * w_edge,
                                               num_poses, psum_axis)
        return _zero_first(jtwjv) + damping * v

    r_t, r_yaw = _edge_residuals(poses, edges)
    r = torch.cat([r_t, r_yaw[:, None]], dim=-1)
    # delta[0] = 0: b0 = 0 and row 0 of A is damping * I
    b = _zero_first(-_edge_jacobian_transpose_apply(poses, edges, r * w_edge,
                                                    num_poses, psum_axis))
    x, rr, p, rs = torch.zeros_like(poses), b, b, (b * b).sum()
    for _ in range(cg_iters):
        ap = normal_matvec(p)
        denom = (p * ap).sum()
        alpha = rs / torch.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        rr = rr - alpha * ap
        rs_new = (rr * rr).sum()
        beta = rs_new / torch.where(rs == 0, 1.0, rs)
        p = rr + beta * p
        rs = rs_new
    new = poses + x
    return torch.cat([new[:, :3], wrap_angle(new[:, 3:])], dim=-1)


def optimize_pose_graph(poses0: torch.Tensor, edges: PoseGraphEdges,
                        num_poses: int, gn_iters: int = 8,
                        cg_iters: int = 32, damping: float = 1e-3,
                        psum_axis=None) -> torch.Tensor:
    """Gauss-Newton + matrix-free CG pose-graph solve, in f32.

    poses0: (M, 4) initial guesses; edges: measurements (maskable), on the
    same device. Pose 0 fixes the gauge: its delta is projected out of the
    CG solve exactly.

    ``damping`` is a Levenberg term, (J^T W J + damping I) delta =
    -J^T W r. Rejected registrations (mask False) can disconnect the graph;
    the damping keeps CG positive definite, so the poses of a component
    with no path to pose 0 stay at their initial values instead of the
    solve going NaN.

    ``psum_axis`` (a ``PairsMesh`` or a process group) sums the J^T terms
    over the ranks, each of which holds its own edges and the same poses0:
    every rank returns the same poses. A rank with no edges still takes
    part in every all-reduce (B2 over no entries gives zeros).

    The JAX package's ``lax.fori_loop``s (quatro_tpu/parallel/posegraph.py:
    151-175) are one device loop of ``gn_iters`` trips here
    (utils/loops.py), each trip a Gauss-Newton iteration with its CG steps
    written out: on the card one trip is a CUDA graph, B2's launches and
    NCCL's all-reduces in it, replayed with nothing read back. A gloo
    group's all-reduce goes through the host and cannot be captured, so
    under one the trips run uncaptured.
    """
    group = axis_group(psum_axis)
    if edges.i.shape[0] == 0 and group is None:
        # nothing to solve: the poses, wrapped
        return torch.cat([poses0[:, :3], wrap_angle(poses0[:, 3:])], dim=-1)
    w_edge = torch.where(edges.mask, edges.weight, 0.0)[:, None]

    def body(consts, state):
        return (_gn_step(PoseGraphEdges(*consts[:6]), consts[6], state[0],
                         num_poses, cg_iters, damping, psum_axis),)

    (poses,) = loops.fori(
        "pose_graph", body, (*edges, w_edge), (poses0,), gn_iters, 1,
        graph=group is None or dist.get_backend(group) == "nccl")
    return poses
