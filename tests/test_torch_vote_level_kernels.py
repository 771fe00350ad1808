"""The vote, the ground leveling and the moment normals at the seams of their
kernels (ops/vote.py, ops/ground.py, ops/normals.moment_normals): the plain
pieces against the JAX package and against the route before the kernels,
on the CPU, on tests/torch_vote_level_cases.py's inputs.

- Route: the plain pieces composed (``solver/vote.py``, ``solver/ground.py``,
  ``ops/frontend.frontend_normals`` on the CPU) equal, bit for bit, the
  route the port ran before them, whose arithmetic is kept here
  (``_old_*``). The leveling's |n| and height are now written in one order
  (``sqrt(fma(n_z, n_z, fma(n_y, n_y, n_x n_x)))`` and ``(l20 c0 + l21 c1)
  + l22 c2``): on the CPU these are the bits of torch.linalg.vector_norm
  and of .sum(-1), and the cases hold that too.
- Against the JAX package: the yaw within 1e-4 rad or in the same bin;
  the translation masks and the vote's masks and sizes exactly on the
  aliased fixture (as tests/test_torch_hypotheses.py holds them);
  ``fit_ground_plane``, ``frame_leveling`` and ``align_ground`` within
  1e-5 with the gates equal (tests/test_torch_refine.py's tolerance);
  ``normals_from_moments`` with validity equal, curvature within 1e-3 and
  normals within 1e-4 on the well-conditioned rows
  (tests/test_torch_frontend.py's).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.ops.pallas_frontend import \
    normals_from_moments as jax_normals_from_moments
from quatro_tpu.solver import ground as jground
from quatro_tpu.solver import vote as jvote

from quatro_tpu_torch.ops import ground as og
from quatro_tpu_torch.ops import normals as on
from quatro_tpu_torch.ops import vote as ov
from quatro_tpu_torch.ops.cliques import _top_k_indices
from quatro_tpu_torch.ops.segment import segment_sums
from quatro_tpu_torch.solver import ground as tground
from quatro_tpu_torch.solver import vote as tvote
from quatro_tpu_torch.solver.clique import top_distinct_cliques
from quatro_tpu_torch.utils import fused
from quatro_tpu_torch.utils.batch import gather_rows
from quatro_tpu_torch.utils.fused import f32
from quatro_tpu_torch.utils.scan import prefix_sum
from quatro_tpu_torch.utils.se3 import rotate_points, yaw_to_rotation

from torch_vote_level_cases import (GROUND_CLOUDS, GROUND_CONFIG, VOTE_CASES,
                                    ground_clouds, ground_pairs,
                                    normals_case, vote_case)

YAW_TOL = 1e-4
GROUND_TOL = 1e-5
JAX_GROUND = jcfg.GroundAlignmentConfig(enabled=True)


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bits(a, b):
    """Equal values, dtypes and shapes, NaN where NaN."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


# ------------------------------------------- the route before the kernels

def _old_entries(src, tgt, mask, adj, num_anchors=64, num_bins=256,
                 min_baseline=1.0, max_weight_baseline=10.0):
    adj_m = adj & mask[..., None, :] & mask[..., :, None]
    deg = adj_m.sum(-1)
    anchor_idx = _top_k_indices(torch.where(mask, deg, -1), num_anchors)
    a_src = gather_rows(src, anchor_idx)[..., :2]
    a_tgt = gather_rows(tgt, anchor_idx)[..., :2]
    adj_rows = gather_rows(adj_m, anchor_idx)
    v0 = src[..., None, :, 0] - a_src[..., 0:1]
    v1 = src[..., None, :, 1] - a_src[..., 1:2]
    w0 = tgt[..., None, :, 0] - a_tgt[..., 0:1]
    w1 = tgt[..., None, :, 1] - a_tgt[..., 1:2]
    cross = v0 * w1 - v1 * w0
    dot = v0 * w0 + v1 * w1
    ang = torch.atan2(cross, dot)
    blen = fused.sqrt(v0 * v0 + v1 * v1)
    wgt = torch.where(adj_rows & (blen > min_baseline),
                      torch.clamp(blen, max=max_weight_baseline), 0.0)
    bins = torch.clamp((ang + math.pi) * (num_bins / (2.0 * math.pi)), 0,
                       num_bins - 1).to(torch.int32)
    lead = mask.shape[:-1]
    ids = torch.where(wgt > 0, bins, num_bins).reshape(*lead, -1)
    norm = torch.clamp(fused.sqrt(cross * cross + dot * dot), min=1e-12)
    vals = torch.stack([wgt, wgt * cross / norm, wgt * dot / norm], -3
                       ).reshape(*lead, 3, -1)
    return ids.to(torch.int32).contiguous(), vals.contiguous()


def _old_yaw_vote(src, tgt, mask, adj, num_modes=1, num_bins=256):
    ids, vals = _old_entries(src, tgt, mask, adj, num_bins=num_bins)
    hist = segment_sums(ids.contiguous(), vals.contiguous(), num_bins)
    votes = hist[..., 0]
    smooth = votes + torch.roll(votes, 1, -1) + torch.roll(votes, -1, -1)

    def refine(b):
        nb = torch.stack([b, (b + 1) % num_bins, (b - 1) % num_bins], -1)
        w = gather_rows(hist, nb)
        window = w[..., 0, :] + w[..., 1, :] + w[..., 2, :]
        return torch.atan2(window[..., 1], window[..., 2])

    if num_modes == 1:
        return refine(torch.argmax(smooth, -1))
    modes = []
    s = smooth
    bins_iota = torch.arange(num_bins)
    for _ in range(num_modes):
        b = torch.argmax(s, -1)
        modes.append(refine(b))
        d = torch.abs((bins_iota - b[..., None] + num_bins // 2) % num_bins
                      - num_bins // 2)
        s = torch.where(d <= 2, -1.0, s)
    return torch.stack(modes, -1)


def _old_translation_masks(src, tgt, mask, yaw, scale, num_hyps, bin_m,
                           refine_scale=1.5, min_votes=2):
    dtype = src.dtype
    bsz, n = mask.shape
    m2 = 2 * n
    rot = yaw_to_rotation(yaw).to(dtype)
    scale = torch.as_tensor(scale, dtype=dtype).expand(bsz)
    t = tgt - scale[:, None, None] * rotate_points(src, rot)
    inv_bin = torch.tensor(1.0 / bin_m, dtype=dtype)

    def grid_keys(offset):
        q = torch.clamp(torch.floor(t * inv_bin + offset).to(torch.int64)
                        + 512, 0, 1023)
        return (q[..., 0] << 20) + (q[..., 1] << 10) + q[..., 2]

    sentinel = (1 << 31) - 1
    key = torch.cat([torch.where(mask, grid_keys(0.0), sentinel),
                     torch.where(mask, grid_keys(0.5) + (1 << 30), sentinel)],
                    -1)
    key_s, order = torch.sort(key, dim=-1, stable=True)
    t_s = gather_rows(torch.cat([t, t], -2), order).transpose(-1, -2)
    pos = torch.arange(m2)
    first = torch.ones((bsz, 1), dtype=torch.bool)
    is_new = (torch.cat([first, key_s[:, 1:] != key_s[:, :-1]], -1)
              & (key_s != sentinel))
    start_pos = torch.where(is_new, pos, m2)
    run_end = torch.where(torch.cat([is_new[:, 1:], first], -1), pos + 1, m2)
    next_start = torch.cummin(run_end.flip(-1), -1).values.flip(-1)
    run_len = torch.where(is_new, next_start - start_pos, 0)
    cand = max(2 * num_hyps + 2, num_hyps)
    rank_key = torch.where(is_new & (run_len >= min_votes),
                           ((4095 - torch.clamp(run_len, max=4095)) << 12)
                           + torch.clamp(pos, max=4095), sentinel)
    rank_s = torch.sort(rank_key, dim=-1).values[:, :cand]
    got = rank_s != sentinel
    starts = torch.where(got, rank_s & 4095, 0)
    counts = torch.where(got, run_len.gather(-1, starts), 0)
    cs3 = prefix_sum(t_s)
    ends = starts + counts

    def at(i):
        return cs3.gather(-1, i[:, None, :].expand(bsz, 3, i.shape[-1]))

    hi3 = at(torch.clamp(ends - 1, 0, m2 - 1))
    lo3 = torch.where(starts[:, None, :] > 0,
                      at(torch.clamp(starts - 1, min=0)), 0.0)
    means = ((hi3 - lo3) / torch.clamp(counts, min=1)[:, None, :]
             ).transpose(-1, -2)
    r = torch.tensor(refine_scale * bin_m, dtype=dtype)
    close = torch.amax(torch.abs(t[:, None, :, :] - means[:, :, None, :]),
                       dim=-1) <= r
    cand_masks = close & mask[:, None, :] & got[:, :, None]
    masks, sizes = top_distinct_cliques(cand_masks, num_hyps)
    return masks, torch.where(sizes >= min_votes, sizes, 0.0)


def _old_vote_hypotheses(src, tgt, mask, adj, scale, num_hyps, bin_m,
                         num_yaw_modes=1):
    if num_yaw_modes == 1:
        yaw = _old_yaw_vote(src, tgt, mask, adj)
        return _old_translation_masks(src, tgt, mask, yaw, scale, num_hyps,
                                      bin_m)
    yaws = _old_yaw_vote(src, tgt, mask, adj, num_modes=num_yaw_modes)
    cand = torch.cat([_old_translation_masks(src, tgt, mask, yaws[:, i],
                                             scale, num_hyps, bin_m)[0]
                      for i in range(num_yaw_modes)], 1)
    masks, sizes = top_distinct_cliques(cand, num_hyps)
    return masks, torch.where(sizes >= 2, sizes, 0.0)


def _old_leveling(points, mask, config):
    """The pre-kernel frame_leveling: torch.linalg.vector_norm for |n| and
    .sum(-1) for the height."""
    plane = tground.fit_ground_plane(points, mask)
    min_cos = f32(math.cos(f32(math.radians(config.max_tilt_deg))))
    ok = ((plane.count >= config.min_points)
          & (plane.normal[..., 2] >= min_cos)
          & (plane.flatness <= f32(config.max_flatness)))
    normal = plane.normal
    n = normal / torch.clamp(torch.linalg.vector_norm(normal, dim=-1,
                                                      keepdim=True),
                             min=1e-12)
    vx, vy, c = n[..., 1], -n[..., 0], n[..., 2]
    k = 1.0 / torch.clamp(1.0 + c, min=1e-6)
    z = torch.zeros_like(c)
    hat = torch.stack([torch.stack([z, z, vy], -1),
                       torch.stack([z, z, -vx], -1),
                       torch.stack([-vy, vx, z], -1)], -2)
    eye = torch.eye(3)
    rot = eye + hat + k[..., None, None] * rotate_points(
        hat, hat.transpose(-1, -2))
    level = torch.where(ok[..., None, None], rot, eye)
    height = torch.where(ok, (level[..., 2, :] * plane.centroid).sum(-1), 0.0)
    return level, height, ok


def _old_align(src, sg, tgt, tg, config):
    lv, h, ok = _old_leveling(torch.stack([src, tgt]), torch.stack([sg, tg]),
                              config)
    (ls, lt), (hs, ht), (ok_s, ok_t) = lv, h, ok
    ok = ok_s & ok_t
    eye = torch.eye(3)
    okm = ok[..., None, None]
    return (torch.where(okm, ls, eye), torch.where(okm, lt, eye),
            torch.where(ok, hs, 0.0), torch.where(ok, ht, 0.0), ok)


# ------------------------------------------------------------------- vote

@pytest.fixture(scope="module", params=VOTE_CASES)
def vcase(request):
    return request.param, vote_case(request.param)


def test_vote_entries_plain_is_the_former_route(vcase):
    name, c = vcase
    got = ov.vote_entries(c["src"], c["tgt"], c["mask"], c["adj"])
    ref = _old_entries(c["src"], c["tgt"], c["mask"], c["adj"])
    assert all(_bits(g, r) for g, r in zip(got, ref)), name
    n = c["mask"].shape[1]
    assert got[0].shape == (c["mask"].shape[0], min(64, n) * n)


def test_vote_case_edges():
    """The cases hold what they are named for: tied degrees across the
    64th anchor, translations past both ends of the grid and at its top
    corner (the second grid's key there is the sort's sentinel)."""
    c = vote_case("ties64")
    adj_m = c["adj"] & c["mask"][..., None, :] & c["mask"][..., :, None]
    deg = torch.where(c["mask"], adj_m.sum(-1), -1)[0]
    top = _top_k_indices(deg[None], 64)[0]
    d = deg[top[63]]
    assert d == deg.sort(descending=True).values[64]
    tied = (deg == d).nonzero()[:, 0]
    chosen = top[deg[top] == d]
    assert len(chosen) < len(tied)
    assert torch.equal(chosen, tied[:len(chosen)])
    c = vote_case("clamp")
    q = torch.floor((c["tgt"] - c["src"]) / c["bin_m"] + 0.5) + 512
    assert bool((q > 1023).all(-1).any()) and bool((q < 0).all(-1).any())


@pytest.mark.parametrize("modes", [1, 2])
def test_yaw_vote_plain_is_the_former_route(vcase, modes):
    name, c = vcase
    got = tvote.yaw_vote(c["src"], c["tgt"], c["mask"], c["adj"],
                         num_modes=modes)
    ref = _old_yaw_vote(c["src"], c["tgt"], c["mask"], c["adj"], modes)
    assert _bits(got, ref), name


@pytest.mark.parametrize("modes", [1, 2])
def test_vote_hypotheses_plain_is_the_former_route(vcase, modes):
    name, c = vcase
    args = (c["src"], c["tgt"], c["mask"], c["adj"], c["scale"],
            c["num_hyps"], c["bin_m"])
    got = tvote.vote_hypotheses(*args, num_yaw_modes=modes)
    ref = _old_vote_hypotheses(*args, num_yaw_modes=modes)
    assert all(_bits(g, r) for g, r in zip(got, ref)), name


def test_translation_vote_masks_plain_is_the_former_route(vcase):
    name, c = vcase
    yaw = _old_yaw_vote(c["src"], c["tgt"], c["mask"], c["adj"])
    args = (c["src"], c["tgt"], c["mask"], yaw, c["scale"], c["num_hyps"],
            c["bin_m"])
    got = tvote.translation_vote_masks(*args)
    ref = _old_translation_masks(*args)
    assert all(_bits(g, r) for g, r in zip(got, ref)), name
    yaws, cand = ov.vote_translation(None, yaw[:, None].contiguous(),
                                     c["src"], c["tgt"], c["mask"],
                                     c["scale"], 1, c["num_hyps"],
                                     c["bin_m"])
    assert _bits(yaws[:, 0], yaw)
    assert cand.shape[2] == ov.candidates(c["num_hyps"], c["mask"].shape[1])


def _same_bin(got, ref, bins=256):
    width = 2 * math.pi / bins
    return (np.floor((got + math.pi) / width)
            == np.floor((ref + math.pi) / width))


@pytest.mark.parametrize("name,modes", [("aliased", 1), ("aliased", 2),
                                        ("batch3_junk", 1), ("n500", 1)])
def test_yaw_vote_against_jax(name, modes):
    c = vote_case(name)
    got = tvote.yaw_vote(c["src"], c["tgt"], c["mask"], c["adj"],
                         num_modes=modes).numpy()
    for b in range(got.shape[0]):
        ref = np.asarray(jvote.yaw_vote(
            jnp.asarray(c["src"][b].numpy()), jnp.asarray(c["tgt"][b].numpy()),
            jnp.asarray(c["mask"][b].numpy()),
            jnp.asarray(c["adj"][b].numpy()), num_modes=modes))
        close = np.abs(got[b] - ref) <= YAW_TOL
        assert np.all(close | _same_bin(got[b], ref)), (name, b, got[b], ref)


@pytest.mark.parametrize("modes", [1, 2])
def test_vote_against_jax_on_the_aliased_fixture(modes):
    """The vote's masks and sizes, and the translation masks at the JAX
    package's own yaw, exactly (no entry of this fixture lies within an
    ulp of a grid edge)."""
    c = vote_case("aliased")
    j = [jnp.asarray(c[k][0].numpy()) for k in ("src", "tgt", "mask", "adj")]
    ref_m, ref_s = jvote.vote_hypotheses(*j, jnp.asarray(1.0, jnp.float32),
                                         num_hyps=3, bin_m=0.75,
                                         num_yaw_modes=modes)
    got_m, got_s = tvote.vote_hypotheses(
        c["src"], c["tgt"], c["mask"], c["adj"], c["scale"], 3, 0.75,
        num_yaw_modes=modes)
    np.testing.assert_array_equal(got_m[0].numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(got_s[0].numpy(), np.asarray(ref_s))
    if modes == 1:
        yaw = jvote.yaw_vote(*j)
        ref_m, ref_s = jvote.translation_vote_masks(
            *j[:3], yaw, jnp.asarray(1.0, jnp.float32), 3, 0.75)
        got_m, got_s = tvote.translation_vote_masks(
            c["src"][0], c["tgt"][0], c["mask"][0],
            torch.from_numpy(np.array(yaw)), torch.tensor(1.0), 3, 0.75)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


# ---------------------------------------------------------------- ground

@pytest.mark.parametrize("name", list(ground_pairs()))
def test_align_ground_plain_is_the_former_route(name):
    s, sg, t, tg = ground_pairs()[name]
    got = tground.align_ground(s, sg, t, tg, GROUND_CONFIG)
    ref = _old_align(s, sg, t, tg, GROUND_CONFIG)
    assert all(_bits(g, r) for g, r in zip(got, ref)), name
    if name == "gates":
        assert got.valid.tolist() == [True, False, False, False, False]


@pytest.mark.parametrize("name", GROUND_CLOUDS)
def test_frame_leveling_plain_is_the_former_route_and_jax(name):
    pts, mask = ground_clouds()[name]
    p, m = torch.from_numpy(pts), torch.from_numpy(mask)
    got = tground.frame_leveling(p, m, GROUND_CONFIG)
    ref = _old_leveling(p, m, GROUND_CONFIG)
    assert all(_bits(g, r) for g, r in zip(got, ref)), name
    jref = jground.frame_leveling(jnp.asarray(pts), jnp.asarray(mask),
                                  JAX_GROUND)
    for g, r in zip(got, jref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=GROUND_TOL, err_msg=name)
    passes = name in ("tilted", "tilted_b", "npow2", "small")
    assert bool(got[2]) == passes
    if name == "no_ground":
        return                  # no plane to compare: both gate it out
    plane = tground.fit_ground_plane(p, m)
    jplane = jground.fit_ground_plane(jnp.asarray(pts), jnp.asarray(mask))
    for g, r in zip(plane, jplane):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=GROUND_TOL, err_msg=name)


def test_align_ground_against_jax():
    s, sg, t, tg = ground_pairs()["gates"]
    got = tground.align_ground(s, sg, t, tg, GROUND_CONFIG)
    for b in range(s.shape[0]):
        ref = jground.align_ground(*(jnp.asarray(x[b].numpy())
                                     for x in (s, sg, t, tg)), JAX_GROUND)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(r),
                                       atol=GROUND_TOL)


def test_ground_fit_pairs_and_norm_order():
    """ground_fit over two sets pairs their clouds: each pair keeps the
    clouds' own leveling where both fits pass, identity and zero heights
    where either fails; and the leveling's written-out |n| equals
    torch.linalg.vector_norm's bits on the CPU over many near-unit
    normals."""
    c = ground_clouds()
    a, b = ([torch.from_numpy(np.stack([c[k][i] for k in names]))
             for i in (0, 1)] for names in (("tilted", "wall"),
                                            ("tilted_b", "bowl")))
    level, height, ok = og.ground_fit(*a, GROUND_CONFIG, other=b)
    la, ha, oka = og.ground_fit(*a, GROUND_CONFIG)
    lb, hb, okb = og.ground_fit(*b, GROUND_CONFIG)
    assert ok.tolist() == [True, False, True, False]
    assert oka.tolist() == [True, False] and okb.tolist() == [True, False]
    eye = torch.eye(3)
    for i, (lv, h) in enumerate(((la, ha), (lb, hb))):
        assert _bits(level[2 * i], lv[0]) and _bits(height[2 * i], h[0])
        assert _bits(level[2 * i + 1], eye)
        assert float(height[2 * i + 1]) == 0.0
    rng = np.random.default_rng(0)
    n = torch.from_numpy(rng.normal(size=(200000, 3)).astype(np.float32))
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    nx, ny, nz = n.unbind(-1)
    written = fused.sqrt(fused.fma(nz, nz, fused.fma(ny, ny, nx * nx)))
    assert _bits(written, torch.linalg.vector_norm(n, dim=-1))


# --------------------------------------------------------------- normals

def _well_conditioned(mom):
    """Rows whose covariance has a clear smallest eigenvalue."""
    _, cov = on.centered_covariance(mom[..., :10].unbind(-1))
    c = torch.stack([torch.stack([cov[0], cov[1], cov[2]], -1),
                     torch.stack([cov[1], cov[3], cov[4]], -1),
                     torch.stack([cov[2], cov[4], cov[5]], -1)], -2).double()
    lam = np.linalg.eigvalsh(c.numpy())
    return (lam[..., 1] - lam[..., 0]) / np.maximum(lam[..., 2], 1e-30) > 1e-2


def test_moment_normals_plain_and_against_jax():
    pts, mask, mom = normals_case()
    got = on.moment_normals(pts, mask, mom)
    ref = on.normals_from_moments(pts, mask, mom)
    assert all(_bits(g, r) for g, r in zip(got, ref))
    assert not bool(got.valid[0, 5]) and not bool(got.valid[1, 7])
    assert float(got.curvature[1, 8]) == 0.0
    cond = _well_conditioned(mom)
    for b in range(pts.shape[0]):
        j = jax_normals_from_moments(jnp.asarray(pts[b].numpy()),
                                     jnp.asarray(mask[b].numpy()),
                                     jnp.asarray(mom[b].numpy()))
        np.testing.assert_array_equal(got.valid[b].numpy(),
                                      np.asarray(j.valid))
        np.testing.assert_allclose(got.curvature[b].numpy(),
                                   np.asarray(j.curvature), atol=1e-3)
        ok = cond[b] & np.asarray(j.valid)
        assert ok.sum() > 0.6 * np.asarray(j.valid).sum()
        np.testing.assert_allclose(got.normals[b].numpy()[ok],
                                   np.asarray(j.normals)[ok], atol=1e-4)
