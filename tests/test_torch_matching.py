"""Descriptor matching: the port's ``match_features`` against the JAX
package's on the JAX package's own descriptors.

Both matchers get the same keypoints and 33-D descriptors (the level_a
VLP-16 pair of tests/golden_specs.py, voxelised and described by the JAX
package at 2048 voxels), so every decision downstream of the descriptors
(top-2 neighbours, mutual test, starvation-fallback union, quality sort,
host-drawn tuple test, compaction) must give the identical correspondence
set, slot for slot.

The descriptors are rounded to multiples of 1/8 first. Both packages
compute d2 = |a|^2 - 2 a.b + |b|^2 with a matrix product, whose rounding
(a few ulps of |a|^2 ~ 3e4, i.e. ~0.004) depends on the library's
summation order; on the raw descriptors, where many voxels share
near-identical histograms, XLA's and torch's orders pick a different first
neighbour on 51 of 2048 rows. On a 1/8 grid every product and partial sum
is an exact f32 (each 11-bin block sums to 100, so all magnitudes stay
below 2^24 / 64), the distances are exact in any order, and the equal
distances that remain are true ties, which the tie rules decide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.io import synthetic as jsyn
from quatro_tpu.ops import matching as jmatch
from quatro_tpu.pipeline import extract_features as jax_extract

from quatro_tpu_torch.ops import matching as tmatch

PAIR = dict(seed=101, yaw_deg=38.0, translation=(2.5, -1.2, 0.04))
CFG = jcfg.PipelineConfig.for_lidar("VLP-16", max_voxels=2048)
CAPACITY = 512


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def features():
    """(src_xyz, tgt_xyz, src_desc, tgt_desc, src_mask, tgt_mask) as numpy
    arrays, from the JAX package's CPU front end."""
    src, tgt, _ = jsyn.make_scan_pair(
        lidar=jcfg.LidarConfig.preset("VLP-16"), **PAIR)
    extract = jax.jit(lambda p, m: jax_extract(p, m, CFG))
    out = []
    for xyz in (src, tgt):
        xyz = xyz[xyz[:, 2] > -1.723 + 0.3]
        pts = np.zeros((32768, 3), np.float32)
        mask = np.zeros(32768, bool)
        pts[:len(xyz)], mask[:len(xyz)] = xyz, True
        vox, desc, dmask, _ = extract(jnp.asarray(pts), jnp.asarray(mask))
        desc = (np.round(np.asarray(desc) * 8.0) / 8.0).astype(np.float32)
        out.append((np.asarray(vox.points), desc, np.asarray(dmask)))
    (sp, sd, sm), (tp, td, tm) = out
    return sp, tp, sd, td, sm, tm


def _both(features, **kw):
    ref = jmatch.match_features(*(jnp.asarray(x) for x in features),
                                capacity=CAPACITY, **kw)
    got = tmatch.match_features(*features, capacity=CAPACITY, device="cpu",
                                **kw)
    return ref, got


def _assert_same(ref, got):
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.src_idx.numpy(),
                                  np.asarray(ref.src_idx))
    np.testing.assert_array_equal(got.tgt_idx.numpy(),
                                  np.asarray(ref.tgt_idx))
    np.testing.assert_array_equal(got.src_xyz.numpy(),
                                  np.asarray(ref.src_xyz))
    np.testing.assert_array_equal(got.tgt_xyz.numpy(),
                                  np.asarray(ref.tgt_xyz))


# crosscheck_min_matches: 64 is the shipping value, under which this pair
# keeps its mutual pairs; 10**6 forces the starvation-fallback union
# (one-directional candidates plus both sides' second neighbours).
@pytest.mark.parametrize("min_matches", [64, 10 ** 6],
                         ids=["mutual", "starvation_fallback"])
def test_match_features_identical(features, min_matches):
    ref, got = _both(features, crosscheck_min_matches=min_matches)
    n = int(np.asarray(ref.mask).sum())
    assert n >= 10, n
    _assert_same(ref, got)


def test_match_features_without_tuple_test(features):
    """The quality-sorted candidates alone (no tuple test) are identical
    too, and differ from the tuple-tested set."""
    ref, got = _both(features, use_tuple_test=False)
    _assert_same(ref, got)
    tested, _ = _both(features)
    assert int(np.asarray(ref.mask).sum()) >= int(
        np.asarray(tested.mask).sum())


@pytest.mark.parametrize("n_cand,trials,seed", [(2048, 100, 0), (40, 100, 3),
                                                 (5, 10, 1)])
def test_tuple_shifts_match_host_draw(n_cand, trials, seed):
    """The shifts are the JAX package's host draw, np.unique row order
    included (quatro_tpu/ops/matching.py::tuple_test_keep)."""
    host_rng = np.random.default_rng(seed)
    ref = np.unique(host_rng.integers(1, max(n_cand - 1, 2),
                                      size=(4 * trials, 2)), axis=0)
    ref = ref[ref[:, 0] != ref[:, 1]][:trials]
    np.testing.assert_array_equal(tmatch.tuple_shifts(n_cand, trials, seed),
                                  ref)


def test_match_features_defaults_to_the_card(features):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        tmatch.match_features(*features)
