"""The multi-hypothesis solver of the port against the JAX package's, on
the same numpy inputs: distinct cliques, the (yaw, translation) vote,
overlap arbitration and register_hypotheses.

Masks, sizes and the winning hypothesis are held exactly (integer counts
and stable sorts on both sides); the vote's yaw within 1e-5 rad and its
histogram within rtol 1e-5 (the segment sums add in another order);
overlaps within one source point (a point at the radius may flip on the
last ulp of the pose); poses within 1e-4 (rotation) and 1e-3 m.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.io.synthetic import make_correspondences
from quatro_tpu.ops.segment_matmul import segment_sums as jax_segment_sums
from quatro_tpu.solver import clique as jclique
from quatro_tpu.solver import vote as jvote
from quatro_tpu.solver.quatro import register_correspondences as jax_solve
from quatro_tpu.solver.quatro import register_hypotheses as jax_hypotheses
from quatro_tpu.solver.scale import tim_consistency_graph as jax_graph
from quatro_tpu.solver.verify import alignment_overlap as jax_overlap
from quatro_tpu.solver.verify import arbitrate_hypotheses as jax_arbitrate
from quatro_tpu.utils.se3 import yaw_to_rotation as jax_yaw_to_rotation

import quatro_tpu_torch.config as tcfg
from quatro_tpu_torch.ops.segment import segment_sums
from quatro_tpu_torch.solver import clique, vote
from quatro_tpu_torch.solver.quatro import (register_correspondences,
                                            register_hypotheses)
from quatro_tpu_torch.solver.scale import tim_consistency_graph
from quatro_tpu_torch.solver.verify import (alignment_overlap,
                                            arbitrate_hypotheses)
from quatro_tpu_torch.types import RegistrationSolution

YAW_TOL = 1e-5
HIST_RTOL = 1e-5
ROT_ATOL, TRANS_ATOL = 1e-4, 1e-3


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x))


def _aliased_fixture(seed=0, n_true=14, n_alias=40, n_noise=200,
                     yaw_deg=35.0, t_true=(2.0, -1.0, 0.1),
                     period=(4.0, 0.0, 0.0), noise=0.02, n_pad=256):
    """tests/test_vote.py's planted aliasing conflict, rebuilt: n_true
    inliers follow (R, t_true), n_alias follow (R, t_true + period), a
    larger rigid structure at the same yaw, and n_noise are junk.
    Returns numpy (src, tgt, mask, R, t, true_idx)."""
    rng = np.random.default_rng(seed)
    rot = np.asarray(jax_yaw_to_rotation(jnp.deg2rad(yaw_deg)))
    t = np.asarray(t_true)

    def make(n, offset):
        src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
        src[:, 2] = rng.uniform(-2, 2, n)
        tgt = src @ rot.T + t + np.asarray(offset) \
            + rng.normal(0, noise, (n, 3))
        return src, tgt

    s1, t1 = make(n_true, (0, 0, 0))
    s2, t2 = make(n_alias, period)
    s3 = rng.uniform(-20, 20, (n_noise, 3)).astype(np.float32)
    t3 = rng.uniform(-20, 20, (n_noise, 3)).astype(np.float32)
    src = np.concatenate([s1, s2, s3]).astype(np.float32)
    tgt = np.concatenate([t1, t2, t3]).astype(np.float32)
    pad = n_pad - src.shape[0]
    src = np.pad(src, ((0, pad), (0, 0)))
    tgt = np.pad(tgt, ((0, pad), (0, 0)))
    mask = np.zeros(n_pad, bool)
    mask[:n_pad - pad] = True
    return src, tgt, mask, rot, t, np.arange(n_true)


def _correspondence_fixture(seed, n_in, n=500):
    src, tgt, _, _ = make_correspondences(
        seed=seed, n_inliers=n_in, n_outliers=n - n_in, yaw_deg=63.0,
        translation=(4.0, -2.5, 0.4))
    mask = np.ones(n, bool)
    mask[-7:] = False
    return src, tgt, mask


def _graphs(src, tgt, mask, noise=0.1):
    """The same adjacency through both packages (held equal here)."""
    ref = jax_graph(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
                    noise, 1.0, use_pallas=False)
    got = tim_consistency_graph(_t(src), _t(tgt), _t(mask), noise, 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    return ref, got


# ------------------------------------------------------------- cliques ----

@pytest.mark.parametrize("force_first", [False, True])
@pytest.mark.parametrize("k", [3, 8])
def test_top_distinct_cliques_matches(force_first, k):
    """Random (S, N) masks of overlapping blocks, singletons and empty
    rows, row 0 small (so force_first moves it)."""
    rng = np.random.default_rng(11 + k)
    s, n = 40, 96
    masks = np.zeros((s, n), bool)
    for i in range(s):
        start = rng.integers(0, n - 20)
        masks[i, start:start + rng.integers(0, 20)] = True
    masks[0] = False
    masks[0, :3] = True
    masks[5] = False
    masks[5, 50] = True                       # a singleton
    ref_m, ref_s = jclique.top_distinct_cliques(jnp.asarray(masks), k,
                                                force_first=force_first)
    got_m, got_s = clique.top_distinct_cliques(_t(masks), k,
                                               force_first=force_first)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("seed,n_in", [(0, 100), (2, 15)])
def test_select_inliers_with_candidates_matches(seed, n_in):
    src, tgt, mask = _correspondence_fixture(seed, n_in)
    ref_adj, adj = _graphs(src, tgt, mask, noise=0.3)
    kw = dict(kcore_threshold=0.5, num_seeds=128, max_size=512,
              swap_rounds=2, top=8)
    ref_sel, ref_valid, ref_grown = jclique.select_inliers_with_candidates(
        ref_adj, jnp.asarray(mask), **kw)
    sel, valid, grown = clique.select_inliers_with_candidates(
        adj, _t(mask), **kw)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ref_sel))
    np.testing.assert_array_equal(grown.numpy(), np.asarray(ref_grown))
    assert bool(valid) == bool(ref_valid)


# ---------------------------------------------------------------- vote ----

def _jax_vote_histogram(src, tgt, mask, adj, num_anchors=64, num_bins=256):
    """The JAX package's yaw histogram, step by step as
    quatro_tpu/solver/vote.py:75-112 computes it (yaw_vote keeps it
    internal)."""
    import jax
    src, tgt, mask = jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask)
    adj_m = adj & mask[None, :] & mask[:, None]
    _, idx = jax.lax.top_k(jnp.where(mask, adj_m.sum(1), -1), num_anchors)
    v0 = src[None, :, 0] - src[idx, 0][:, None]
    v1 = src[None, :, 1] - src[idx, 1][:, None]
    w0 = tgt[None, :, 0] - tgt[idx, 0][:, None]
    w1 = tgt[None, :, 1] - tgt[idx, 1][:, None]
    cross, dot = v0 * w1 - v1 * w0, v0 * w0 + v1 * w1
    blen = jnp.sqrt(v0 * v0 + v1 * v1)
    wgt = jnp.where(adj_m[idx] & (blen > 1.0), jnp.minimum(blen, 10.0), 0.0)
    bins = jnp.clip((jnp.arctan2(cross, dot) + jnp.pi)
                    * (num_bins / (2.0 * jnp.pi)), 0,
                    num_bins - 1).astype(jnp.int32)
    ids = jnp.where(wgt > 0, bins, num_bins).reshape(-1)
    norm = jnp.maximum(jnp.sqrt(cross * cross + dot * dot), 1e-12)
    vals = jnp.stack([wgt, wgt * cross / norm, wgt * dot / norm]
                     ).reshape(3, -1)
    return np.asarray(ids), np.asarray(jax_segment_sums(ids, vals, num_bins))


@pytest.mark.parametrize("num_modes", [1, 2])
def test_yaw_vote_matches(num_modes):
    src, tgt, mask, *_ = _aliased_fixture()
    ref_adj, adj = _graphs(src, tgt, mask)
    ref = np.asarray(jvote.yaw_vote(jnp.asarray(src), jnp.asarray(tgt),
                                    jnp.asarray(mask), ref_adj,
                                    num_modes=num_modes))
    got = vote.yaw_vote(_t(src), _t(tgt), _t(mask), adj,
                        num_modes=num_modes).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=YAW_TOL)
    if num_modes == 1:
        assert abs(np.degrees(got) - 35.0) < 1.5
    ref_ids, ref_hist = _jax_vote_histogram(src, tgt, mask, ref_adj)
    ids, vals = vote.yaw_vote_entries(_t(src), _t(tgt), _t(mask), adj)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    np.testing.assert_allclose(segment_sums(ids, vals, 256).numpy(),
                               ref_hist, rtol=HIST_RTOL, atol=1e-4)


@pytest.mark.parametrize("yaw_deg,num_hyps", [(35.0, 3), (35.0, 2),
                                              (0.0, 2)])
def test_translation_vote_masks_match(yaw_deg, num_hyps):
    """Given the same yaw (the JAX package's vote, or a fixed one), the
    same masks and sizes."""
    src, tgt, mask, *_ = _aliased_fixture()
    ref_adj, adj = _graphs(src, tgt, mask)
    yaw = np.float32(np.deg2rad(yaw_deg))
    if yaw_deg:
        yaw = np.asarray(jvote.yaw_vote(jnp.asarray(src), jnp.asarray(tgt),
                                        jnp.asarray(mask), ref_adj))
    ref_m, ref_s = jvote.translation_vote_masks(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask),
        jnp.asarray(yaw), jnp.asarray(1.0, jnp.float32), num_hyps, 0.75)
    got_m, got_s = vote.translation_vote_masks(
        _t(src), _t(tgt), _t(mask), _t(yaw), torch.tensor(1.0), num_hyps,
        0.75)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("num_yaw_modes", [1, 2])
def test_vote_hypotheses_match(num_yaw_modes):
    """Through the whole vote, each package with its own yaw: no entry of
    this fixture lies within an ulp of a grid edge, so the masks agree
    exactly."""
    src, tgt, mask, _, _, true_idx = _aliased_fixture()
    ref_adj, adj = _graphs(src, tgt, mask)
    ref_m, ref_s = jvote.vote_hypotheses(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), ref_adj,
        jnp.asarray(1.0, jnp.float32), num_hyps=3, bin_m=0.75,
        num_yaw_modes=num_yaw_modes)
    got_m, got_s = vote.vote_hypotheses(
        _t(src), _t(tgt), _t(mask), adj, torch.tensor(1.0), num_hyps=3,
        bin_m=0.75, num_yaw_modes=num_yaw_modes)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    assert max(got_m[v, true_idx].float().mean() for v in range(3)) >= 0.8


def test_vote_hypotheses_all_invalid():
    n = 128
    z = torch.zeros((n, 3))
    masks, sizes = vote.vote_hypotheses(
        z, z, torch.zeros(n, dtype=torch.bool),
        torch.zeros((n, n), dtype=torch.bool), torch.tensor(1.0),
        num_hyps=2, bin_m=0.75)
    assert float(sizes.max()) == 0 and not bool(masks.any())


def test_translation_vote_rejects_overflowing_capacity():
    """The occupancy rank key packs positions in 12 bits: N > 2048 is
    refused, not clamped."""
    n = 2049
    z = torch.zeros((n, 3))
    with pytest.raises(ValueError, match="2048"):
        vote.translation_vote_masks(z, z, torch.ones(n, dtype=torch.bool),
                                    torch.tensor(0.0), torch.tensor(1.0),
                                    num_hyps=2, bin_m=0.75)


# -------------------------------------------------------------- verify ----

def _yaw_rot(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]], np.float32)


def _planar_aliasing_case():
    """tests/test_verify.py's planar-aliasing regression, rebuilt with its
    own generator: 10 correct correspondences, 16 aliased by a 3 m
    in-scene shift, 38 junk, over a scene cloud and its transformed copy.
    """
    rng = np.random.default_rng(1234)
    cloud = (rng.uniform(-1, 1, (600, 3))
             * np.array([30, 30, 3])).astype(np.float32)
    rot = _yaw_rot(0.6)
    t_true = np.array([4.0, -2.0, 0.5], np.float32)
    tgt_cloud = (cloud @ rot.T + t_true).astype(np.float32)
    n = 64
    src_c = cloud[:n].copy()
    tgt_c = src_c @ rot.T + t_true
    t_alias = t_true + rot @ np.array([3.0, 0, 0], np.float32)
    tgt_c[10:26] = src_c[10:26] @ rot.T + t_alias
    tgt_c[26:] = rng.uniform(-40, 40, (n - 26, 3))
    return (src_c, tgt_c.astype(np.float32), np.ones(n, bool), cloud,
            tgt_cloud, np.ones(len(cloud), bool), t_true)


def _as_port_solution(sols):
    return RegistrationSolution(*(_t(getattr(sols, f.name)) for f in
                                  dataclasses.fields(RegistrationSolution)))


@pytest.mark.parametrize("max_src_points", [2048, 256])
def test_arbitration_matches(max_src_points):
    """The JAX package's hypotheses, scored by both packages: overlaps
    within one source point, the same winner; the winner is the correct
    pose, not the larger aliased clique."""
    src_c, tgt_c, mask, cloud, tgt_cloud, m_cloud, t_true = \
        _planar_aliasing_case()
    sols = jax_hypotheses(jnp.asarray(src_c), jnp.asarray(tgt_c),
                          jnp.asarray(mask), jcfg.SolverConfig(), k=4)
    ref_best, ref_ov = jax_arbitrate(
        sols, jnp.asarray(cloud), jnp.asarray(m_cloud),
        jnp.asarray(tgt_cloud), jnp.asarray(m_cloud), radius=0.3,
        max_src_points=max_src_points)
    best, ov = arbitrate_hypotheses(
        _as_port_solution(sols), _t(cloud), _t(m_cloud), _t(tgt_cloud),
        _t(m_cloud), radius=0.3, max_src_points=max_src_points)
    n_src = len(cloud[::-(-len(cloud) // max_src_points)])
    np.testing.assert_allclose(ov.numpy(), np.asarray(ref_ov), rtol=0,
                               atol=1.0 / n_src + 1e-7)
    valid = np.asarray(sols.valid)
    assert int(torch.argmax(torch.where(_t(valid), ov, -1.0))) == \
        int(np.argmax(np.where(valid, np.asarray(ref_ov), -1.0)))
    np.testing.assert_array_equal(best.translation.numpy(),
                                  np.asarray(ref_best.translation))
    assert np.linalg.norm(best.translation.numpy() - t_true) < 0.1


def test_alignment_overlap_blocks_and_masks():
    """Rows not a multiple of the block, masked rows on both sides."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(700, 3)).astype(np.float32) * 20
    src_mask = rng.uniform(size=700) > 0.3
    tgt = (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32)
    tgt_mask = rng.uniform(size=700) > 0.2
    rot, tr = _yaw_rot(0.01), np.array([0.02, 0.0, 0.01], np.float32)
    ref = jax_overlap(jnp.asarray(pts), jnp.asarray(src_mask),
                      jnp.asarray(tgt), jnp.asarray(tgt_mask),
                      jnp.asarray(rot), jnp.asarray(tr), radius=0.15,
                      row_block=256)
    got = alignment_overlap(_t(pts), _t(src_mask), _t(tgt), _t(tgt_mask),
                            _t(rot), _t(tr), radius=0.15, row_block=256)
    assert 0.1 < float(got) < 0.9
    assert abs(float(got) - float(ref)) <= 1.0 / src_mask.sum() + 1e-7


# ---------------------------------------------------- register_hypotheses ----

def _configs(**kw):
    j = jcfg.SolverConfig(num_hypotheses=4, num_vote_hypotheses=2, **kw)
    return j, tcfg.config_from_dict({"solver": dataclasses.asdict(j)}).solver


def _assert_same_hypotheses(ref, got):
    """Masks, validity, rotation inliers and rotations of every hypothesis;
    translations and COTE inliers of every hypothesis with a rotation
    consensus. A junk clique of 3-4 outliers has none (0 rotation
    inliers): COTE then sees isolated intervals of equal cost on each
    axis, and which one is first at the minimum is decided by the last ulp
    of the rotated points (the JAX package rotates with an XLA matrix
    product, the port with three f32 products), so its translation is any
    of the candidates in either package."""
    np.testing.assert_array_equal(got.max_clique_mask.numpy(),
                                  np.asarray(ref.max_clique_mask))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.num_rotation_inliers.numpy(),
                                  np.asarray(ref.num_rotation_inliers))
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(ref.rotation),
                               atol=ROT_ATOL)
    decided = (got.num_rotation_inliers > 0).numpy() | ~got.valid.numpy()
    assert decided[0]
    np.testing.assert_array_equal(
        got.final_inlier_mask.numpy()[decided],
        np.asarray(ref.final_inlier_mask)[decided])
    np.testing.assert_allclose(got.translation.numpy()[decided],
                               np.asarray(ref.translation)[decided],
                               atol=TRANS_ATOL)


@pytest.mark.parametrize("case", ["corr-0-100", "corr-1-40", "corr-3-5",
                                  "aliased"])
def test_register_hypotheses_matches(case):
    if case == "aliased":
        src, tgt, mask, *_ = _aliased_fixture()
        kw = dict(noise_bound=0.1)
    else:
        _, seed, n_in = case.split("-")
        src, tgt, mask = _correspondence_fixture(int(seed), int(n_in))
        kw = {}
    jc, tc = _configs(**kw)
    ref = jax_hypotheses(jnp.asarray(src), jnp.asarray(tgt),
                         jnp.asarray(mask), jc, k=4)
    got = register_hypotheses(src, tgt, mask, tc, k=4, device="cpu")
    assert got.rotation.shape == (6, 3, 3)
    _assert_same_hypotheses(ref, got)
    single = register_correspondences(src, tgt, mask, tc, device="cpu")
    np.testing.assert_array_equal(got.max_clique_mask[0].numpy(),
                                  single.max_clique_mask.numpy())
    np.testing.assert_array_equal(got.translation[0].numpy(),
                                  single.translation.numpy())
    assert bool(got.valid[0]) == bool(single.valid)
    ref_single = jax_solve(jnp.asarray(src), jnp.asarray(tgt),
                           jnp.asarray(mask), jc)
    np.testing.assert_array_equal(np.asarray(ref.max_clique_mask[0]),
                                  np.asarray(ref_single.max_clique_mask))


def test_register_hypotheses_kcore_mode():
    """The non-clique branch: hypothesis 0 from select_inliers, the
    candidates from a separate growth pass."""
    src, tgt, mask = _correspondence_fixture(1, 40)
    jc, tc = _configs(inlier_selection_mode="kcore")
    ref = jax_hypotheses(jnp.asarray(src), jnp.asarray(tgt),
                         jnp.asarray(mask), jc, k=4)
    got = register_hypotheses(src, tgt, mask, tc, k=4, device="cpu")
    _assert_same_hypotheses(ref, got)


def test_solution_stack_and_take():
    src, tgt, mask = _correspondence_fixture(0, 100)
    _, tc = _configs()
    sols = register_hypotheses(src, tgt, mask, tc, k=4, device="cpu")
    row = sols.take(torch.tensor(2))
    for f in dataclasses.fields(RegistrationSolution):
        np.testing.assert_array_equal(getattr(row, f.name).numpy(),
                                      getattr(sols, f.name)[2].numpy())
        assert getattr(sols, f.name).device.type == "cpu"
    assert sols.gnc_iterations.dtype == torch.int32
