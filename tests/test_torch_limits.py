"""Sizes past the card kernels' former limits, on the CPU against the JAX
package (ROADMAP.md C 29: sizes the card refused and the JAX
package runs). Each kernel's wrapper now takes these sizes on the card by a
wide route, bit for bit its plain version (tests/test_torch_limits_gpu.py);
here the plain versions meet the JAX functions at the first size past each
former limit, on tests/torch_limit_cases.py's seeded inputs, with the
tolerances of each op's own port test:

- the polish at N = 4097 (tests/test_torch_polish_kernels.py: rotation
  1e-4, translation 1e-3, valid and the rotation inliers' count exactly);
- ICP's update at 8193 source rows, one pass of ``refine_icp``
  (tests/test_torch_icp_kernels.py: 1e-6 rad, 1e-5 m);
- the neighbour lists at K = 65 and 96 (idx and valid exactly, d2 within
  2 ulps) and their normals (validity exactly, curvature and normals on
  well-conditioned rows within 1e-3);
- the CZM at nine zones (patch ids exactly but within 1e-5 of a ring or
  sector edge, tests/test_torch_czm.py);
- B8 at five channels and at 768 columns (tests/test_torch_kernels.py:
  counts exactly, sums within 1e-5 relative, 1e-4 absolute);
- the leveling at 2^18 + 1 points (1e-5, the gates exactly);
- the growth at N = 4097, max_size 4098 (the cliques exactly); and at
  6144 vertices the JAX package's early completion absorbing a non-clique
  by its f32 rounding, which the port's exact counts do not (a standing
  divergence, ROADMAP.md);
- two sizes that the JAX package refuses itself: the translation vote
  past 2048 correspondences and a range image of 2^17 pixels.

A host walk of csrc/tree.cuh's strided fold holds the wide routes' sum
order against ``fused.pairwise_sum``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.ops import segment_matmul as jsm
from quatro_tpu.ops.neighbors import radius_neighbors as jax_neighbors
from quatro_tpu.ops.normals import estimate_normals as jax_normals
from quatro_tpu.preprocessing import patchwork as jpw
from quatro_tpu.preprocessing.projection import project_to_range_image
from quatro_tpu.solver import ground as jground
from quatro_tpu.solver import quatro as jquatro
from quatro_tpu.solver import vote as jvote
from quatro_tpu.solver.clique import grow_greedy_cliques
from quatro_tpu.solver.icp import refine_icp as jax_icp

from quatro_tpu_torch.config import LidarConfig
from quatro_tpu_torch.ops import cliques as tcl
from quatro_tpu_torch.ops import czm
from quatro_tpu_torch.ops import icp as ticp
from quatro_tpu_torch.ops import segment
from quatro_tpu_torch.ops.neighbors import (NeighborLists,
                                            radius_neighbors_plain)
from quatro_tpu_torch.ops.normals import estimate_normals_plain
from quatro_tpu_torch.ops.range_image import range_image
from quatro_tpu_torch.solver import ground as tground
from quatro_tpu_torch.solver import vote as tvote
from quatro_tpu_torch.utils import fused
from quatro_tpu_torch.utils.se3 import rotation_geodesic_error

import torch_limit_cases as lc
from test_torch_preprocessing import _near_czm_edge
from torch_icp_cases import correspond_args, dof_of, icp_clouds
from torch_vote_level_cases import GROUND_CONFIG

SEG_RTOL, SEG_ATOL = 1e-5, 1e-4
GROUND_TOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _j(x):
    return jnp.asarray(np.asarray(x))


# ------------------------------------------------------------- the polish --

def _jax_solve(case):
    fields = {f.name for f in dataclasses.fields(jcfg.SolverConfig)}
    kw = {k: v for k, v in dataclasses.asdict(case["config"]).items()
          if k in fields}
    kw["use_pallas_graph"] = False
    cfg = jcfg.SolverConfig(**kw)

    def one(src, tgt, clique, valid, scale):
        return jquatro._solve_from_inliers(src, tgt, clique, valid, scale,
                                           cfg, jnp.eye(3), False)

    rows = jax.jit(jax.vmap(one, in_axes=(None, None, 0, 0, 0)))
    return rows(*(_j(case[k][0]) for k in
                  ("src", "tgt", "clique", "valid", "scale")))


@pytest.mark.parametrize("opts", [{}, dict(rotation_estimation_algorithm="FGR",
                                           cote_mode="weighted_mean")],
                         ids=["gnc_tls", "fgr"])
def test_polish_past_its_row_limit_matches_jax(opts):
    """The whole polish of six rows of 4097 points (the kernels' wide
    route on the card) against ``jax.vmap`` of the JAX package's."""
    from torch_polish_cases import solve_case
    case = lc.polish_case(lc.POLISH_N, opts)
    got = solve_case(case)
    ref = _jax_solve(case)
    np.testing.assert_array_equal(got.valid[0].numpy(),
                                  np.asarray(ref.valid))
    for h in (0, 1):                 # the true inliers, and a few outliers
        np.testing.assert_allclose(got.rotation[0, h].numpy(),
                                   np.asarray(ref.rotation[h]), atol=1e-4)
        np.testing.assert_allclose(got.translation[0, h].numpy(),
                                   np.asarray(ref.translation[h]), atol=1e-3)
        assert (int(got.num_rotation_inliers[0, h])
                == int(ref.num_rotation_inliers[h]))


# -------------------------------------------------------------------- ICP --

@pytest.fixture(scope="module")
def clouds():
    return icp_clouds()


@pytest.fixture(scope="module")
def target_normals(clouds):
    vox, vmask, _, cfg = clouds
    f = cfg.fpfh
    nbrs = radius_neighbors_plain(vox[1], vmask[1], f.normal_radius,
                                  f.max_neighbors_normal)
    return estimate_normals_plain(vox[1], nbrs)


@pytest.mark.parametrize("yaw_only", [False, True])
def test_icp_update_past_its_row_limit_matches_jax(clouds, target_normals,
                                                   yaw_only):
    """One Gauss-Newton pass over 8193 source rows against the JAX
    package's refine_icp at one iteration."""
    vox, vmask, gt, cfg = clouds
    args = correspond_args(vox, vmask, target_normals.normals,
                           target_normals.valid, gt, cfg)
    src, smask = lc.wide_source(vox, vmask)
    args = (src[None].expand(2, -1, -1).contiguous(),
            smask[None].expand(2, -1).contiguous()) + args[2:]
    ic = cfg.icp
    step = torch.zeros(1, dtype=torch.int64)
    rows, ok = ticp.icp_correspond(*args, step, ic.huber_delta)
    assert rows.shape[1] == lc.ICP_ROWS > ticp.UPDATE_MAX_ROWS
    rot, trans, _ = ticp.icp_update(rows, ok, args[2], args[3], step,
                                    dof_of(yaw_only), ic.damping,
                                    ic.min_correspondences)
    jc = jcfg.IcpConfig(enabled=True, iterations=1, hold_iterations=1,
                        yaw_only=yaw_only, max_source_points=lc.ICP_ROWS)
    for b in range(2):
        ref = jax_icp(_j(src), _j(smask), _j(vox[1]), _j(args[5][b]),
                      _j(args[6][b]), jnp.ones(vox.shape[1], bool),
                      _j(args[2][b]), _j(args[3][b]), jc)
        drot = float(rotation_geodesic_error(
            torch.from_numpy(np.array(ref.rotation)), rot[b]))
        assert drot < 1e-6, drot
        np.testing.assert_allclose(trans[b].numpy(),
                                   np.asarray(ref.translation), atol=1e-5)


# ---------------------------------------------- neighbour lists, normals --

@pytest.mark.parametrize("k", lc.LIST_WIDTHS_PAST)
def test_neighbor_lists_and_normals_past_64_match_jax(clouds, k):
    """The lists of both clouds at K past the two-slot warp route, and the
    normals on the JAX package's own lists."""
    vox, vmask, _, cfg = clouds
    r = cfg.fpfh.normal_radius
    got = radius_neighbors_plain(vox, vmask, r, k)
    for b in range(2):
        ref = jax_neighbors(_j(vox[b]), _j(vmask[b]), r, k)
        np.testing.assert_array_equal(got.idx[b].numpy(), np.asarray(ref.idx))
        np.testing.assert_array_equal(got.valid[b].numpy(),
                                      np.asarray(ref.valid))
        np.testing.assert_allclose(got.dist2[b].numpy(),
                                   np.asarray(ref.dist2), rtol=2.4e-7, atol=0)
        lists = NeighborLists(*(torch.from_numpy(np.array(x)) for x in ref))
        normals = estimate_normals_plain(vox[b], lists)
        jn = jax_normals(_j(vox[b]), ref)
        valid = np.asarray(jn.valid)
        np.testing.assert_array_equal(normals.valid.numpy(), valid)
        np.testing.assert_allclose(normals.curvature.numpy()[valid],
                                   np.asarray(jn.curvature)[valid], atol=1e-3)
        cond = _well_conditioned(vox[b].numpy(), np.asarray(ref.idx),
                                 np.asarray(ref.valid))
        assert cond.sum() >= 0.6 * valid.sum()
        np.testing.assert_allclose(normals.normals.numpy()[cond],
                                   np.asarray(jn.normals)[cond], atol=1e-3)


def _well_conditioned(p, idx, valid):
    """Rows whose covariance's two least eigenvalues are apart and whose
    normal is not edge-on to the viewpoint (test_torch_icp_kernels.py's
    rule)."""
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


# --------------------------------------------------------------- the CZM --

def test_czm_nine_zones_matches_jax():
    """The CZM bins of a VLP-16 cloud under a nine-zone table (the point
    kernel's table past its eight parameter slots on the card), the ninth
    zone holding points."""
    tc = lc.nine_zone_config()
    jc = jcfg.PatchworkConfig(**lc.NINE_ZONES)
    vox, vmask = _vlp16_cloud()
    pid, zb, chan, weights, b0 = czm.czm_points_plain(vox[None], vmask[None],
                                                      tc)
    jid, jin = jpw.czm_bin(_j(vox), _j(vmask), jc)
    near = _near_czm_edge(vox.numpy(), tc) & vmask.numpy()
    jid = np.where(np.asarray(jin), np.asarray(jid), tc.num_patches)
    differ = pid[0].numpy() != jid
    assert not (differ & ~near).any()
    got_zones = np.searchsorted(np.asarray(tc.min_ranges_each_zone),
                                np.hypot(*vox.numpy()[:, :2].T), "right") - 1
    assert (got_zones[pid[0].numpy() < tc.num_patches] == 8).sum() > 100


def _vlp16_cloud():
    """The VLP-16 ICP pair's raw source scan, all of its points."""
    from quatro_tpu_torch.config import LidarConfig as TL
    from quatro_tpu_torch.io.synthetic import make_scan_pair
    src, _, _ = make_scan_pair(lidar=TL.preset("VLP-16"), seed=3,
                               yaw_deg=10.0, translation=(1.0, 0.5, 0.0))
    pts = torch.from_numpy(np.ascontiguousarray(src, dtype=np.float32))
    return pts, torch.ones(len(pts), dtype=torch.bool)


# -------------------------------------------------------------------- B8 --

@pytest.mark.parametrize("name", list(lc.HIST_SHAPES))
def test_cross_histogram_past_its_shared_memory_matches_jax(name):
    """Five channels, and 768 columns of two (192 KB of a block's rows),
    against the Pallas kernel in interpret mode."""
    ia, ib, w, a_pad, b_pad = lc.histogram_inputs(name)
    ref = np.asarray(jsm.cross_histogram(_j(ia[0]), _j(ib[0]), _j(w[0]),
                                         a_pad, b_pad, interpret=True))
    got = segment.cross_histogram(ia, ib, w, a_pad, b_pad)[0].numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[0], ref[0])          # counts
    np.testing.assert_allclose(got, ref, rtol=SEG_RTOL, atol=SEG_ATOL)


# --------------------------------------------------------- the leveling --

def test_leveling_past_its_fold_matches_jax():
    """frame_leveling and the plane fit of one cloud of 2^18 + 1 points."""
    pts, mask = lc.ground_cloud()
    got = tground.frame_leveling(pts, mask, GROUND_CONFIG)
    ref = jground.frame_leveling(_j(pts), _j(mask),
                                 jcfg.GroundAlignmentConfig(enabled=True))
    assert bool(got[2]) and bool(ref[2])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GROUND_TOL)
    plane = tground.fit_ground_plane(pts, mask)
    jplane = jground.fit_ground_plane(_j(pts), _j(mask))
    for g, r in zip(plane, jplane):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=GROUND_TOL)


# ---------------------------------------------------------- the growth --

def test_growth_past_the_exact_limit_matches_jax():
    """A complete graph of 4097 vertices at max_size 4098 (the first call
    the card refused): the seed absorbs its 4096 candidates whole in both
    packages."""
    adj, scores, mask = lc.complete_graph(lc.GROW_N)
    got = tcl.grow_cliques(adj, scores, mask, 1, lc.GROW_N + 1, 8, 16)
    ref = grow_greedy_cliques(_j(adj[0]), _j(scores[0]), _j(mask[0]),
                              num_seeds=1, max_size=lc.GROW_N + 1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
    assert bool(got.all())


def test_growth_early_completion_rests_on_f32_rounding_in_jax():
    """At 6144 vertices with one edge missing among the seed's candidates
    the JAX package's f32 test (the edge sum against csz (csz - 1), both
    rounded) absorbs the candidates whole, a set that is no clique; the
    port's test on exact counts does not, and its round adds one vertex,
    as the growth does on any set that is no clique."""
    n = lc.ROUNDING_N
    (u, v), = lc.ROUNDING_MISSING
    adj, scores, mask = lc.complete_graph(n, lc.ROUNDING_MISSING)
    ref = np.asarray(grow_greedy_cliques(_j(adj[0]), _j(scores[0]),
                                         _j(mask[0]), num_seeds=1,
                                         max_size=n))[0]
    assert ref.all() and not bool(adj[0, u, v])      # both ends, no edge
    csz = n - 1
    assert csz * (csz - 1) - 2 == int(np.float32(csz) * np.float32(csz - 1))
    adj_f = adj.to(torch.float32)
    clique = torch.nn.functional.one_hot(torch.tensor([[0]]), n).float()
    cand = adj_f[:, :1] * mask.float()[:, None]
    clique, cand = tcl._grow_round((adj_f, tcl._tiebreak(n, adj.device)),
                                   (clique, cand), n, n)
    assert int(clique.sum()) == 2 and int(cand.sum()) == csz - 1


# ------------------------------------------- the reference's own limits --

def test_vote_past_2048_is_refused_as_jax_refuses_it():
    """The translation vote packs 2N ranks in 12 bits: the JAX package
    asserts N <= 2048 and the port refuses the same N (both devices check
    before launching; the card's entries kernel's 4096 is not reached)."""
    n = 2304
    rng = np.random.default_rng(23)
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    tgt = src + np.float32(0.05)
    mask = np.ones(n, bool)
    adj = np.zeros((n, n), bool)
    with pytest.raises(AssertionError, match="2048"):
        jvote.vote_hypotheses(_j(src), _j(tgt), _j(mask), _j(adj),
                              jnp.float32(1.0), 2, 1.0)
    with pytest.raises(ValueError, match="2048"):
        tvote.vote_hypotheses(*(torch.from_numpy(x) for x in
                                (src, tgt, mask, adj)),
                              torch.tensor(1.0), 2, 1.0)
    ok = 2048
    tvote.vote_hypotheses(*(torch.from_numpy(x[:ok]) for x in
                            (src, tgt, mask)),
                          torch.from_numpy(adj[:ok, :ok]), torch.tensor(1.0),
                          2, 1.0)


def _lidar(rows, cols, jax_side):
    kw = dict(n_scan=rows, horizon_scan=cols, ang_res_x=360.0 / cols,
              ang_res_y=2.0, ang_bottom=15.1, ground_scan_ind=min(7, rows))
    return (jcfg.LidarConfig(**kw) if jax_side else LidarConfig(**kw))


def test_range_image_limit_is_the_references():
    """The projection packs (pixel, range) in 32 bits with 15 range bits:
    the JAX package takes images of up to 2^17 - 1 pixels (1 x 131071)
    and asserts past them; the port takes and refuses the same (on both
    devices: the check comes before the launch)."""
    rng = np.random.default_rng(17)
    pts = rng.uniform(-30, 30, (1, 4096, 3)).astype(np.float32)
    mask = np.ones((1, 4096), bool)
    big = (1 << 17) - 1
    project_to_range_image(_j(pts[0]), _j(mask[0]), _lidar(1, big, True))
    range_image(torch.from_numpy(pts), torch.from_numpy(mask),
                _lidar(1, big, False), 0.1, None)
    for rows, cols in ((64, 2048), (1, big + 1)):
        with pytest.raises(AssertionError):
            project_to_range_image(_j(pts[0]), _j(mask[0]),
                                   _lidar(rows, cols, True))
        with pytest.raises(ValueError, match="overflows"):
            range_image(torch.from_numpy(pts), torch.from_numpy(mask),
                        _lidar(rows, cols, False), 0.1, None)


# ------------------------------------------------ the strided fold's order --

def _strided_fold(x, levels):
    """csrc/tree.cuh::strided_fold on the host: the 2^levels members taken
    in bit-reversed order, summed pairwise by a stack (f32)."""
    stack = []
    for j in range(1 << levels):
        k = int(format(j, f"0{levels}b")[::-1], 2) if levels else 0
        cur = np.float32(x[k])
        b = j
        while b & 1:
            cur = np.float32(stack.pop() + cur)
            b >>= 1
        stack.append(cur)
    return stack[0]


@pytest.mark.parametrize("n,threads", [(4097, 1024), (8193, 1024),
                                       (70001, 1024), (97, 32), (200, 32)])
def test_strided_fold_walk_equals_pairwise_sum(n, threads):
    """A thread's fold of its members t, t + T, ... by the strided fold,
    then the halving levels below T, equals ``fused.pairwise_sum`` bit for
    bit (the GNC's, ICP update's, leveling's and normals' wide routes)."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=n).astype(np.float32) * np.float32(1e3)
    p = 1 << (n - 1).bit_length()
    pad = np.zeros(p, np.float32)
    pad[:n] = x
    levels = int(math.log2(p // threads))
    part = np.array([_strided_fold(pad[t::threads], levels)
                     for t in range(threads)], np.float32)
    half = threads // 2
    while half >= 1:
        part = (part[:half] + part[half:2 * half]).astype(np.float32)
        half //= 2
    want = fused.pairwise_sum(torch.from_numpy(x))
    assert part[0].tobytes() == want.numpy().tobytes()
