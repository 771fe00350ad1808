"""The solver's kernels B1 (consistency graph) and B2 (segment sums): their
plain versions, which the wrappers run on the CPU, against the JAX
package's Pallas kernels in interpret mode and against numpy.

B1 is held exactly (the plain version repeats the Pallas kernel's
arithmetic); B2 within rtol 1e-5 / atol 1e-4, the f32 summation-order
bound between the TPU kernel's 3-term bf16 split, numpy and torch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quatro_tpu.io.synthetic import make_correspondences
from quatro_tpu.ops.pallas_kernels import consistency_graph_pallas
from quatro_tpu.ops.segment_matmul import segment_sums as jax_segment_sums
from quatro_tpu.solver.scale import tim_consistency_graph as jax_graph

from quatro_tpu_torch.ops import kernels, segment
from quatro_tpu_torch.ops.launch import LAUNCHES
from quatro_tpu_torch.solver.scale import tim_consistency_graph

SEG_RTOL, SEG_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _graph_inputs(case):
    """The two inputs of tests/test_pallas_kernels.py at N = 256."""
    if case == "random":
        rng = np.random.default_rng(1234)
        src = rng.uniform(0, 50, (256, 3)).astype(np.float32)
        tgt = rng.uniform(0, 50, (256, 3)).astype(np.float32)
    else:
        src, tgt, _, _ = make_correspondences(seed=2, n_inliers=64,
                                              n_outliers=192)
    return src, tgt


@pytest.mark.parametrize("case", ["random", "correspondences"])
def test_consistency_graph_plain_equals_pallas(case):
    src, tgt = _graph_inputs(case)
    ref = np.asarray(consistency_graph_pallas(jnp.asarray(src),
                                              jnp.asarray(tgt), 0.6,
                                              interpret=True))
    before = dict(LAUNCHES)
    got = kernels.consistency_graph(torch.from_numpy(src),
                                    torch.from_numpy(tgt), 0.6).numpy()
    assert LAUNCHES == before            # the plain version launches nothing
    off = ~np.eye(256, dtype=bool)
    np.testing.assert_array_equal(got[off], ref[off])
    assert 0 < got[off].sum() < off.sum()


@pytest.mark.parametrize("use_pallas", [None, True, False])
def test_tim_consistency_graph_equals_jax(use_pallas):
    """Every use_pallas_graph value computes the plain form on the CPU,
    equal to the JAX package's graph."""
    src, tgt = _graph_inputs("correspondences")
    mask = np.ones(256, bool)
    mask[-9:] = False
    ref = np.asarray(jax_graph(jnp.asarray(src), jnp.asarray(tgt),
                               jnp.asarray(mask), 0.3, 1.0,
                               use_pallas=False))
    got = tim_consistency_graph(torch.from_numpy(src), torch.from_numpy(tgt),
                                torch.from_numpy(mask), 0.3, 1.0,
                                use_pallas=use_pallas).numpy()
    np.testing.assert_array_equal(got, ref)


def _segment_inputs(n, k, p_pad, seed):
    """ids in [-3, p_pad + 3): some out of range on both sides."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-3, p_pad + 3, n).astype(np.int32)
    vals = rng.normal(0, 10, (k, n)).astype(np.float32)
    return ids, vals


def _add_at(ids, vals, p_pad):
    out = np.zeros((p_pad, vals.shape[0]), np.float64)
    keep = (ids >= 0) & (ids < p_pad)
    np.add.at(out, ids[keep], vals[:, keep].T.astype(np.float64))
    return out


# Patchwork's shape class (p_pad 640, N two TPU tiles) and the vote's
# (N = 64 anchors x 1024 correspondences, K = 3, 256 bins)
@pytest.mark.parametrize("n,k,p_pad", [(2 * 8192, 5, 640), (65536, 3, 256)])
def test_segment_sums_plain(n, k, p_pad):
    ids, vals = _segment_inputs(n, k, p_pad, seed=n + k)
    ref = np.asarray(jax_segment_sums(jnp.asarray(ids), jnp.asarray(vals),
                                      p_pad, interpret=True))
    before = dict(LAUNCHES)
    got = segment.segment_sums(torch.from_numpy(ids), torch.from_numpy(vals),
                               p_pad).numpy()
    assert LAUNCHES == before
    assert got.shape == (p_pad, k) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=SEG_RTOL, atol=SEG_ATOL)
    np.testing.assert_allclose(got, _add_at(ids, vals, p_pad),
                               rtol=SEG_RTOL, atol=SEG_ATOL)


def test_segment_sums_checks_inputs():
    ids, vals = _segment_inputs(100, 2, 8, seed=0)
    with pytest.raises(TypeError):
        segment.segment_sums(torch.from_numpy(ids).long(),
                             torch.from_numpy(vals), 8)
    with pytest.raises(ValueError):
        segment.segment_sums(torch.from_numpy(ids[:50]),
                             torch.from_numpy(vals), 8)
