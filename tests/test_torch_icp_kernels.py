"""The plain versions of ICP's four kernels against the JAX package on the
CPU, on tests/torch_icp_cases.py's VLP-16 voxels (2048 a cloud, a batch of
two): ``radius_neighbors_plain`` (csrc/knn.cu), ``estimate_normals_plain``
(csrc/neighbor_normals.cu), ``icp_correspond_plain`` and
``icp_update_plain`` (csrc/icp.cu). On the card each kernel is held bit for
bit against its plain version by tests/test_torch_kernels_gpu.py.

Tolerances, and what was measured on these inputs:
- the neighbour lists: idx and valid equal on every row of both clouds
  under every mask case and list width; d2 within 2 ulps (measured:
  bit-equal: the plain version forms |p|^2 and the dot product's terms as
  the JAX package's compiled program fuses them);
- the normals on the JAX package's own lists: validity equal, curvature
  within 1e-3, normals within 1e-3 on well-conditioned rows
  (tests/test_torch_refine.py's bands; measured: 1.6e-4 and 9.4e-6);
- the correspondences against the JAX package's ``correspond`` written
  with its own ``rotate_points`` and ``pairwise_sq_dists``: ok equal on
  every row, the residual within 1e-5 m, the normal exactly and p x n
  within 1e-4 (measured: all bit-equal);
- one pass: the pose after ``icp_update_plain`` against the JAX
  package's ``refine_icp`` at one iteration within 1e-6 rad / 1e-5 m
  (measured: 3.4e-9 rad / 2.4e-7 m), inliers and rmse at the start pose
  (two iterations with the update gated off) equal and within 1e-5
  relative;
- a batch of two: each row bit-equal to its own call;
- the lists kernel's culling (``knn_tiles_culled``, csrc/knn.cu): on the
  clouds above and tests/torch_icp_cases.py's edge cases, no (row, column
  tile) pair that the predicate skips at the final lists' K-th key holds
  a key of ``radius_neighbors_plain``'s list, and no column that the f32
  screen rules out has a key below the K-th (exact: a predicate, no
  tolerance).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.ops.neighbors import pairwise_sq_dists as jax_sq_dists
from quatro_tpu.ops.neighbors import radius_neighbors as jax_neighbors
from quatro_tpu.ops.normals import estimate_normals as jax_normals
from quatro_tpu.solver.icp import refine_icp as jax_icp
from quatro_tpu.utils.se3 import rotate_points as jax_rotate

import quatro_tpu_torch.config as tcfg
from quatro_tpu_torch.ops import icp as ticp
from quatro_tpu_torch.ops import neighbors as tnb
from quatro_tpu_torch.ops.neighbors import (NeighborLists,
                                            radius_neighbors,
                                            radius_neighbors_plain)
from quatro_tpu_torch.ops.normals import (estimate_normals,
                                          estimate_normals_plain)
from quatro_tpu_torch.solver.icp import refine_icp
from quatro_tpu_torch.utils.se3 import rotation_geodesic_error

from torch_icp_cases import (FEW_VALID, LIST_EDGE_CASES, LIST_WIDTHS,
                             correspond_args, dof_of, icp_clouds,
                             list_edge_case, list_masks)


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _j(x):
    return jnp.asarray(np.asarray(x))


@pytest.fixture(scope="module")
def clouds():
    return icp_clouds()


@pytest.fixture(scope="module")
def target_normals(clouds):
    """The target's lists and normals, the port's plain versions."""
    vox, vmask, _, cfg = clouds
    f = cfg.fpfh
    nbrs = radius_neighbors_plain(vox[1], vmask[1], f.normal_radius,
                                  f.max_neighbors_normal)
    return estimate_normals_plain(vox[1], nbrs)


# ----------------------------------------------------- neighbour lists --

@pytest.mark.parametrize("case", ["as_is", "few_valid", "all_masked"])
def test_radius_neighbors_plain_matches_jax(clouds, case):
    """Both clouds in one call (a batch of two) against the JAX package's
    per-cloud lists."""
    vox, vmask, _, cfg = clouds
    f = cfg.fpfh
    mask = list_masks(vmask)[case]
    got = radius_neighbors(vox, mask, f.normal_radius,
                           f.max_neighbors_normal)
    assert got.idx.shape == (2, vox.shape[1], f.max_neighbors_normal)
    for b in range(2):
        ref = jax_neighbors(_j(vox[b]), _j(mask[b]), f.normal_radius,
                            f.max_neighbors_normal)
        np.testing.assert_array_equal(got.idx[b].numpy(),
                                      np.asarray(ref.idx))
        np.testing.assert_array_equal(got.valid[b].numpy(),
                                      np.asarray(ref.valid))
        np.testing.assert_allclose(got.dist2[b].numpy(),
                                   np.asarray(ref.dist2), rtol=2.4e-7,
                                   atol=0)
    idx, valid = got.idx[1].numpy(), got.valid[1].numpy()
    if case == "few_valid":
        # FEW_VALID valid columns first (by distance), then the masked
        # ones in index order
        live = np.nonzero(mask[1].numpy())[0]
        rest = np.setdiff1d(np.arange(vox.shape[1]), live)
        for row in live[:5]:
            assert sorted(idx[row, :FEW_VALID]) == list(live)
            np.testing.assert_array_equal(
                idx[row, FEW_VALID:], rest[:idx.shape[1] - FEW_VALID])
    if case == "all_masked":
        assert not valid.any()
        np.testing.assert_array_equal(idx, np.broadcast_to(
            np.arange(idx.shape[1]), idx.shape))


@pytest.mark.parametrize("k", LIST_WIDTHS)
def test_radius_neighbors_plain_widths_match_jax(clouds, k):
    vox, vmask, _, cfg = clouds
    got = radius_neighbors(vox[1], vmask[1], cfg.fpfh.normal_radius, k)
    ref = jax_neighbors(_j(vox[1]), _j(vmask[1]), cfg.fpfh.normal_radius, k)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    # self first on every valid row
    live = vmask[1].numpy()
    assert (got.idx.numpy()[live, 0] == np.nonzero(live)[0]).all()


def test_radius_neighbors_batch_rows_are_their_own_calls(clouds):
    vox, vmask, _, cfg = clouds
    f = cfg.fpfh
    got = radius_neighbors(vox, vmask, f.normal_radius,
                           f.max_neighbors_normal)
    for b in range(2):
        one = radius_neighbors(vox[b], vmask[b], f.normal_radius,
                               f.max_neighbors_normal)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)


def test_radius_neighbors_refuses_more_neighbours_than_points():
    pts = torch.zeros(5, 3)
    with pytest.raises(ValueError):
        radius_neighbors(pts, torch.ones(5, dtype=torch.bool), 1.0, 6)


def _screen_passes(points, mask, kth_d2):
    """(B, N, N) bool: the columns that csrc/knn.cu's f32 screen keeps for
    each row at the K-th d2 ``kth_d2``: every column of an unsafe row or
    tile (``knn_tile_bounds``), else a = sq3(p - q) <= thr, the culling
    predicate's threshold with the column's tile maximum."""
    lo, hi, qmax, unsafe = tnb.knn_tile_bounds(points, mask)
    n = points.shape[-2]
    tile = torch.arange(n) // tnb.KNN_TILE
    d = points[..., :, None, :] - points[..., None, :, :]
    a = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    sqp = tnb.sq_norms(points)
    one = torch.ones(())
    thr = ((kth_d2[..., None] + (tnb._SLACK * one) * (
        sqp[..., None] + qmax[..., tile][..., None, :]))
        * ((1.0 + tnb._SLACK) * one)) + (2.0 ** -100) * one
    thr = torch.where((kth_d2 < tnb._FLT_MAX)[..., None], thr, float("inf"))
    open_ = ~(sqp <= tnb._SAFE_NORM)[..., None] | unsafe[..., tile][..., None, :]
    return open_ | (a <= thr)


_CULL_CASES = ("as_is", "few_valid", *LIST_EDGE_CASES)


@pytest.mark.parametrize("k", [48, 96])
@pytest.mark.parametrize("case", _CULL_CASES)
def test_radius_knn_culling_keeps_every_listed_key(clouds, case, k):
    """csrc/knn.cu skips a (row, column tile) pair once gap2 from the row
    to the tile's box is above the screen's threshold at the row's K-th
    key, and screens out a column once a = |p - q|^2 in f32 is above it:
    at the final lists' K-th key (the smallest any run reaches) neither
    may drop a key of ``radius_neighbors_plain``'s lists. The ICP clouds
    (Morton order) must cull most tiles, or the check says nothing."""
    if case in ("as_is", "few_valid"):
        vox, vmask, _, _ = clouds
        pts, mask = vox, list_masks(vmask)[case]
    else:
        pts, mask = list_edge_case(case)
    lists = radius_neighbors_plain(pts, mask, 0.5, k)
    kth = lists.dist2[..., k - 1]
    culled = tnb.knn_tiles_culled(pts, mask, kth)
    assert culled.shape == (*mask.shape, -(-mask.shape[-1] // tnb.KNN_TILE))
    listed = culled.gather(-1, lists.idx.long() // tnb.KNN_TILE)
    assert not listed.any()
    passes = _screen_passes(pts, mask, kth)
    listed_valid = mask.gather(-1, lists.idx.long().flatten(-2)).view_as(
        lists.idx)
    assert passes.gather(-1, lists.idx.long())[listed_valid].all()
    if case == "as_is":
        assert culled.float().mean() > 0.5
        assert not passes.all()


# --------------------------------------------------------------- normals --

def _well_conditioned(vt, idx, valid):
    """Rows whose normal is a well-posed function of their list (as
    tests/test_torch_refine.py: the f64 PCA's two smallest eigenvalues
    apart by > 1 % of the largest, the point off the tangent plane
    through the viewpoint by > 0.1 % of its range)."""
    p = vt.astype(np.float64)
    w = valid.astype(np.float64)
    q = p[idx]
    cnt = np.maximum(w.sum(1), 1.0)[:, None]
    mean = (w[..., None] * q).sum(1) / cnt
    d = (q - mean[:, None]) * np.sqrt(w)[..., None]
    lam, vec = np.linalg.eigh(np.einsum("nki,nkj->nij", d, d)
                              / cnt[..., None])
    gap = (lam[:, 1] - lam[:, 0]) / np.maximum(lam[:, 2], 1e-30)
    side = np.abs((vec[:, :, 0] * p).sum(1)) / np.maximum(
        np.linalg.norm(p, axis=1), 1e-9)
    return (w.sum(1) >= 3) & (gap > 1e-2) & (side > 1e-3)


@pytest.mark.parametrize("case", ["as_is", "few_valid"])
def test_estimate_normals_plain_matches_jax(clouds, case):
    """Both clouds' normals in one call on the JAX package's lists."""
    vox, vmask, _, cfg = clouds
    f = cfg.fpfh
    mask = list_masks(vmask)[case]
    refs = [jax_neighbors(_j(vox[b]), _j(mask[b]), f.normal_radius,
                          f.max_neighbors_normal) for b in range(2)]
    lists = NeighborLists(*(torch.from_numpy(np.stack(
        [np.asarray(r[i]) for r in refs])) for i in range(3)))
    got = estimate_normals(vox, lists)
    assert got.normals.shape == vox.shape
    for b in range(2):
        ref = jax_normals(_j(vox[b]), refs[b])
        valid = np.asarray(ref.valid)
        np.testing.assert_array_equal(got.valid[b].numpy(), valid)
        np.testing.assert_allclose(got.curvature[b].numpy()[valid],
                                   np.asarray(ref.curvature)[valid],
                                   atol=1e-3)
        cond = _well_conditioned(vox[b].numpy(), np.asarray(refs[b].idx),
                                 np.asarray(refs[b].valid))
        if not (b == 1 and case == "few_valid"):    # 20 points: none
            assert cond.sum() >= 0.6 * valid.sum()
        np.testing.assert_allclose(got.normals[b].numpy()[cond],
                                   np.asarray(ref.normals)[cond], atol=1e-3)
        assert (got.normals[b].numpy()[~valid] == 0).all()
        one = estimate_normals(vox[b], NeighborLists(*(t[b] for t in lists)))
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)


# ------------------------------------------------------- correspondences --

def _jax_correspond(src, smask, rot, trans, tgt, tgt_ok, normals, gate):
    """solver/icp.py's ``correspond`` (quatro_tpu/solver/icp.py:108-117)
    with the JAX package's own rotate_points and pairwise_sq_dists: (j,
    ok, r, p)."""
    p = jax_rotate(src, rot) + trans
    d2 = jax_sq_dists(p, tgt)
    d2 = jnp.where(tgt_ok[None, :], d2, jnp.finfo(jnp.float32).max)
    j = jnp.argmin(d2, axis=1)
    d2min = jnp.take_along_axis(d2, j[:, None], axis=1)[:, 0]
    ok = smask & (d2min <= gate * gate)
    r = jnp.sum(normals[j] * (p - tgt[j]), axis=-1)
    return j, ok, r, p


@pytest.mark.parametrize("case", ["as_is", "all_masked"])
def test_icp_correspond_plain_matches_jax(clouds, target_normals, case):
    vox, vmask, gt, cfg = clouds
    args = correspond_args(vox, vmask, target_normals.normals,
                           target_normals.valid, gt, cfg, case)
    gates = args[-1]
    step = torch.tensor([cfg.icp.hold_iterations])   # the first annealed
    rows, ok = ticp.icp_correspond(*args, step, cfg.icp.huber_delta)
    assert rows.shape == (2, args[0].shape[1], 8)
    gate = gates[cfg.icp.hold_iterations]
    for b in range(2):
        j, jok, r, p = _jax_correspond(*(_j(a[b]) for a in args[:7]),
                                       _j(gate))
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(jok))
        np.testing.assert_allclose(rows[b, :, 7].numpy(), np.asarray(r),
                                   atol=1e-5)
        n = np.asarray(args[6][b])[np.asarray(j)]
        np.testing.assert_allclose(rows[b, :, 3:6].numpy(), n, atol=0)
        np.testing.assert_allclose(rows[b, :, :3].numpy(),
                                   np.cross(np.asarray(p), n), atol=1e-4)
        w = rows[b, :, 6].numpy()
        absr = np.abs(np.asarray(r))
        huber = np.where(absr <= cfg.icp.huber_delta, 1.0,
                         cfg.icp.huber_delta / np.maximum(absr, 1e-12))
        np.testing.assert_allclose(w, np.asarray(jok) * huber, rtol=1e-4)
        one = ticp.icp_correspond(*(a[b:b + 1] for a in args[:7]), gates,
                                  step, cfg.icp.huber_delta)
        assert torch.equal(one[0][0], rows[b]) and torch.equal(one[1][0],
                                                               ok[b])
    if case == "all_masked":
        assert not ok[1].any() and (rows[1, :, 6] == 0).all()
    else:
        assert ok.float().mean() > 0.5


# ------------------------------------------------------------ one pass --

def _pose_from(args, b):
    return (np.asarray(args[2][b]), np.asarray(args[3][b]))


@pytest.mark.parametrize("yaw_only", [False, True])
@pytest.mark.parametrize("case", ["as_is", "all_masked"])
def test_icp_update_plain_matches_jax_one_pass(clouds, target_normals,
                                               yaw_only, case):
    """One Gauss-Newton pass from each start pose against the JAX
    package's refine_icp at one iteration (its gate the held one); an
    all-masked pair's pose passes through unchanged in both."""
    vox, vmask, gt, cfg = clouds
    args = correspond_args(vox, vmask, target_normals.normals,
                           target_normals.valid, gt, cfg, case)
    ic = cfg.icp
    step = torch.zeros(1, dtype=torch.int64)
    rows, ok = ticp.icp_correspond(*args, step, ic.huber_delta)
    rot, trans, nxt = ticp.icp_update(rows, ok, args[2], args[3], step,
                                      dof_of(yaw_only), ic.damping,
                                      ic.min_correspondences)
    assert nxt.tolist() == [1]
    jc = jcfg.IcpConfig(enabled=True, iterations=1, hold_iterations=1,
                        yaw_only=yaw_only)
    for b in range(2):
        r0, t0 = _pose_from(args, b)
        ref = jax_icp(_j(vox[0]), _j(vmask[0]), _j(vox[1]),
                      _j(args[5][b]), _j(args[6][b]),
                      jnp.ones(vox.shape[1], bool), _j(r0), _j(t0), jc)
        drot = float(rotation_geodesic_error(
            torch.from_numpy(np.array(ref.rotation)), rot[b]))
        assert drot < 1e-6, drot
        np.testing.assert_allclose(trans[b].numpy(),
                                   np.asarray(ref.translation), atol=1e-5)
        if case == "all_masked" and b == 1:
            assert torch.equal(rot[b], args[2][b])
            assert torch.equal(trans[b], args[3][b])
        one = ticp.icp_update(rows[b:b + 1], ok[b:b + 1], args[2][b:b + 1],
                              args[3][b:b + 1], step, dof_of(yaw_only),
                              ic.damping, ic.min_correspondences)
        assert torch.equal(one[0][0], rot[b])
        assert torch.equal(one[1][0], trans[b])
    if yaw_only:                       # roll and pitch as they started
        rel = rot.numpy() @ np.swapaxes(args[2].numpy(), 1, 2)
        assert np.abs(rel[:, 2, 2] - 1.0).max() < 1e-6


def test_icp_inliers_and_rmse_at_the_start_pose_match_jax(clouds,
                                                          target_normals):
    """The final correspondences at an unchanged pose: min_correspondences
    above the row count gates every update off in both packages, so the
    inliers and rmse are those of the start pose at the last gate."""
    vox, vmask, gt, cfg = clouds
    args = correspond_args(vox, vmask, target_normals.normals,
                           target_normals.valid, gt, cfg)
    big = 10 * vox.shape[1]
    tc = tcfg.IcpConfig(enabled=True, iterations=2, min_correspondences=big)
    jc = jcfg.IcpConfig(enabled=True, iterations=2, min_correspondences=big)
    got = refine_icp(vox[:1].expand(2, -1, -1), vmask[:1].expand(2, -1),
                     args[4], vmask[1:].expand(2, -1), args[6],
                     target_normals.valid[None].expand(2, -1), args[2],
                     args[3], tc)
    for b in range(2):
        r0, t0 = _pose_from(args, b)
        ref = jax_icp(_j(vox[0]), _j(vmask[0]), _j(vox[1]), _j(vmask[1]),
                      _j(args[6][b]), _j(target_normals.valid), _j(r0),
                      _j(t0), jc)
        assert torch.equal(got.rotation[b], args[2][b])
        assert int(got.num_inliers[b]) == int(ref.num_inliers) > 0
        np.testing.assert_allclose(float(got.rmse[b]), float(ref.rmse),
                                   rtol=1e-5)
        assert not bool(got.converged[b])


def test_refine_icp_unbatched_is_the_batch_row(clouds, target_normals):
    """The (V, 3) call adds a pair axis: the same bits as row 0 of a
    batch."""
    vox, vmask, gt, cfg = clouds
    args = correspond_args(vox, vmask, target_normals.normals,
                           target_normals.valid, gt, cfg)
    tc = tcfg.IcpConfig(enabled=True, iterations=3)
    tgt_ok = target_normals.valid
    one = refine_icp(vox[0], vmask[0], vox[1], vmask[1],
                     target_normals.normals, tgt_ok, args[2][0], args[3][0],
                     tc)
    batch = refine_icp(vox[:1].expand(2, -1, -1), vmask[:1].expand(2, -1),
                       args[4], vmask[1:].expand(2, -1), args[6],
                       tgt_ok[None].expand(2, -1), args[2], args[3], tc)
    for field, a, b in zip(one._fields, one, batch):
        assert torch.equal(a, b[0]), field
    assert float(rotation_geodesic_error(one.rotation, args[2][0])) > 0
    assert math.isfinite(float(one.rmse))
