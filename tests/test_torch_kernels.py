"""The solver's kernels B1 (consistency graph) and B2 (segment sums) and
the preprocessing kernels B8-B11: their plain versions, which the wrappers
run on the CPU, against the JAX package's Pallas kernels in interpret mode
and against numpy.

B1 is held exactly (the plain version repeats the Pallas kernel's
arithmetic); B2, B8 and B9's sums within rtol 1e-5 / atol 1e-4, the f32
summation-order bound between the TPU kernels' bf16 splits, numpy and
torch; counts, B9's membership and bf16-rounded channels, and B10 and B11
exactly.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quatro_tpu.io.synthetic import make_correspondences
from quatro_tpu.ops.pallas_kernels import consistency_graph_pallas
from quatro_tpu.ops import segment_matmul as jsm
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


# an arbitrary 640 bins, N two TPU tiles (Patchwork's own p_pad is 512),
# and the vote's shape (N = 64 anchors x 1024 correspondences, K = 3, 256
# bins)
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


def test_plain_sqrt_is_correctly_rounded_on_every_mkl_path():
    """torch's CPU square root goes through MKL, whose rounding depends on
    the host's instruction set (one ulp off on ~0.6 % of distances with
    AVX-512, 15-17 % with SSE4.2, none with AVX2), so plain distances that
    decide graph edges differed from host to host. utils/fused.sqrt rounds
    correctly on each path; MKL reads its instruction set once per
    process, hence a subprocess each."""
    code = ("import numpy as np, torch\n"
            "from quatro_tpu_torch.utils import fused\n"
            "v = np.random.default_rng(0).uniform(0, 2500, 300000)"
            ".astype(np.float32)\n"
            "bad = int((fused.sqrt(torch.from_numpy(v)).numpy() "
            "!= np.sqrt(v)).sum())\n"
            "print(bad, 'values rounded differently')\n"
            "raise SystemExit(int(bad > 0))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for isa in ("SSE4_2", "AVX2", "AVX512"):
        env = dict(os.environ, MKL_ENABLE_INSTRUCTIONS=isa, PYTHONPATH=root)
        res = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, (isa, res.stdout, res.stderr[-500:])


# ------------------------------------------------- preprocessing, B8-B11 --

def _b(*arrays):
    """numpy arrays as tensors with a batch axis of one."""
    return [torch.from_numpy(np.ascontiguousarray(a))[None] for a in arrays]


def test_cross_histogram_plain_equals_pallas():
    """tests/test_pallas_kernels.py's shape (N = 8192, 640 x 128 bins) with
    ids out of range on both axes."""
    rng = np.random.default_rng(64)
    n, a_pad, b_pad = 8192, 640, 128
    ia = rng.integers(-2, a_pad + 9, n).astype(np.int32)
    ib = rng.integers(-2, b_pad + 3, n).astype(np.int32)
    w = np.stack([rng.uniform(size=n) > 0.3,
                  rng.normal(-1.7, 0.4, n)]).astype(np.float32)
    ref = np.asarray(jsm.cross_histogram(jnp.asarray(ia), jnp.asarray(ib),
                                         jnp.asarray(w), a_pad, b_pad,
                                         interpret=True))
    before = dict(LAUNCHES)
    got = segment.cross_histogram(*_b(ia, ib, w), a_pad, b_pad)[0].numpy()
    assert LAUNCHES == before
    assert got.shape == (2, a_pad, b_pad) and got.dtype == np.float32
    np.testing.assert_array_equal(got[0], ref[0])          # counts
    np.testing.assert_allclose(got, ref, rtol=SEG_RTOL, atol=SEG_ATOL)
    keep = (ia >= 0) & (ia < a_pad) & (ib >= 0) & (ib < b_pad)
    exp = np.zeros((2, a_pad, b_pad))
    for k in range(2):
        np.add.at(exp[k], (ia[keep], ib[keep]), w[k][keep])
    np.testing.assert_allclose(got, exp, rtol=SEG_RTOL, atol=SEG_ATOL)


def _fit_inputs(seed, n=8192, p_pad=640, p_cnt=600):
    """tests/test_pallas_kernels.py's plane-fit inputs: ids in [-2, p_cnt +
    3), random channels, a table with zero rows past p_cnt and integer
    flags."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2, p_cnt + 3, n).astype(np.int32)
    chan = rng.normal(size=(5, n)).astype(np.float32)
    tab = rng.normal(size=(p_pad, 5)).astype(np.float32)
    tab[:, 4] = rng.integers(0, 16, p_pad)
    tab[p_cnt:] = 0.0
    return ids, chan, tab, p_pad, p_cnt


@pytest.mark.parametrize("exact", [False, True])
def test_fit_iteration_moments_plain_equals_pallas(exact):
    ids, chan, tab, p_pad, p_cnt = _fit_inputs(80)
    jargs = (jnp.asarray(ids), jnp.asarray(chan), jnp.asarray(tab))
    ref = np.asarray(jsm.fit_iteration_moments(*jargs, p_pad, p_cnt,
                                               exact=exact, interpret=True))
    targs = _b(ids, chan, tab)
    before = dict(LAUNCHES)
    got = segment.fit_iteration_moments(*targs, p_pad, p_cnt,
                                        exact=exact)[0].numpy()
    assert LAUNCHES == before
    assert got.shape == (p_pad, 10)
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])    # membership counts
    np.testing.assert_allclose(got, ref, rtol=SEG_RTOL, atol=SEG_ATOL)
    # the membership and the (bf16-rounded) channels before the sum
    vals = jsm.table_lookup(*jargs[::2])
    member = (jargs[0] < p_cnt) & (vals[0] * jargs[1][0] + vals[1]
                                   * jargs[1][1] + vals[2] * jargs[1][2]
                                   < vals[3])
    mom = jsm._moment_rows(jargs[1]) * member
    if not exact:
        mom = mom.astype(jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(
        segment.fit_moment_channels(*targs, p_cnt, exact)[0].numpy(),
        np.asarray(mom))
    assert 0 < int(member.sum()) < len(ids)


def test_classify_points_plain_equals_pallas():
    ids, chan, tab, p_pad, p_cnt = _fit_inputs(81)
    ref = np.asarray(jsm.classify_points(
        jnp.asarray(ids), jnp.asarray(chan), jnp.asarray(tab), p_pad, p_cnt,
        interpret=True))
    before = dict(LAUNCHES)
    got = segment.classify_points(*_b(ids, chan, tab), p_pad,
                                  p_cnt)[0].numpy()
    assert LAUNCHES == before
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) > 3


def test_image_lookup_plain_equals_pallas():
    """Packed pixel words below 2**20 (exact in the TPU kernel's f32), ids
    out of the image on both sides."""
    rng = np.random.default_rng(82)
    rows, cols, n = 64, 1800, 8192
    flat = rng.integers(-5, rows * cols + 5, n).astype(np.int32)
    img = rng.integers(-1, 1 << 20, (rows, cols)).astype(np.int32)
    ref = np.asarray(jsm.image_lookup(jnp.asarray(flat),
                                      jnp.asarray(img, jnp.float32), rows,
                                      cols, interpret=True))
    before = dict(LAUNCHES)
    got = segment.image_lookup(*_b(flat, img), rows, cols)[0].numpy()
    assert LAUNCHES == before
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref.astype(np.int32))
    assert (got[(flat < 0) | (flat >= rows * cols)] == 0).all()


def test_preprocessing_wrappers_check_inputs():
    ids, chan, tab, p_pad, p_cnt = _fit_inputs(83, n=100)
    i, c, t = _b(ids, chan, tab)
    with pytest.raises(TypeError):
        segment.fit_iteration_moments(i.long(), c, t, p_pad, p_cnt)
    with pytest.raises(ValueError):
        segment.classify_points(i, c, t[:, :p_cnt], p_pad, p_cnt)
    with pytest.raises(ValueError):
        segment.cross_histogram(i, i[:, :50], c[:, :2], p_pad, 128)
    with pytest.raises(TypeError):
        segment.image_lookup(i, c[:, :1, :64].float(), 1, 64)
