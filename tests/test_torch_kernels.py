"""The solver's kernels B1 (consistency graph) and B2 (segment sums) and
the preprocessing kernels B8-B11: their plain versions, which the wrappers
run on the CPU, against the JAX package's Pallas kernels in interpret mode
and against numpy. And the radius-pair kernels' tile culling (B3's
``tile_bounds`` and ``tiles_in_radius``, which B4 and B5 take too): it
never rejects a tile pair that holds a pair within the radius, at the
normal radius and at the FPFH radius. And the premise of B6's kernel: the
first minimum over all columns is the least (d2, index) over column splits
merged in any order, bit-equal to ``nearest_neighbors_plain`` and, on 1/8-
grid descriptors, to the JAX package's Pallas 1-NN. And every kernel
launcher's ctypes signature (``_build.SIGNATURES`` / ``EXTRA``) against
its C function in csrc/.

B1 is held exactly (the plain version repeats the Pallas kernel's
arithmetic); B2, B8 and B9's sums within rtol 1e-5 / atol 1e-4, the f32
summation-order bound between the TPU kernels' bf16 splits, numpy and
torch; counts, B9's membership and bf16-rounded channels, and B10 and B11
exactly.
"""

import functools
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quatro_tpu.io.synthetic import make_correspondences
from quatro_tpu.ops import pallas_frontend as jpf
from quatro_tpu.ops.pallas_kernels import consistency_graph_pallas
from quatro_tpu.ops import segment_matmul as jsm
from quatro_tpu.ops.segment_matmul import segment_sums as jax_segment_sums
from quatro_tpu.solver.scale import tim_consistency_graph as jax_graph

from quatro_tpu_torch.ops import frontend as tf
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
# the vote's shape (N = 64 anchors x 1024 correspondences, K = 3, 256
# bins), and the pose graph's J^T apply (two ends of 19 edges, K = 4, 12
# poses), where the JAX package takes its one-hot fallback (N is no
# multiple of 8192)
@pytest.mark.parametrize("n,k,p_pad", [(2 * 8192, 5, 640), (65536, 3, 256),
                                       (38, 4, 12)])
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


# Pallas interpret mode at N = 8192 (the TPU kernel's tile: its body runs,
# one tile), and N = 5000, no multiple of 8192 (its einsum).
@pytest.mark.parametrize("n,k,p_pad", [(8192, 5, 512), (5000, 4, 640)],
                         ids=["pallas", "einsum"])
def test_table_lookup_plain_equals_pallas(n, k, p_pad):
    """B12's plain version against segment_matmul.table_lookup with ids
    out of range on both sides, on two clouds: equal bit for bit (the
    TPU kernel's three-way bf16 split and the einsum's exact one-hot both
    reproduce every f32 row), zeros for the out-of-range ids."""
    rng = np.random.default_rng(n)
    ids = rng.integers(-4, p_pad + 4, (2, n)).astype(np.int32)
    tab = rng.normal(0, 3, (2, p_pad, k)).astype(np.float32)
    ref = np.stack([np.asarray(jsm.table_lookup(
        jnp.asarray(ids[b]), jnp.asarray(tab[b]), interpret=True))
        for b in range(2)])
    ids_t, tab_t = torch.from_numpy(ids), torch.from_numpy(tab)
    before = dict(LAUNCHES)
    got = segment.table_lookup(ids_t, tab_t).numpy()
    assert LAUNCHES == before
    assert got.shape == (2, k, n) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    oor = (ids < 0) | (ids >= p_pad)
    assert oor.any() and (got.transpose(0, 2, 1)[oor] == 0).all()
    np.testing.assert_array_equal(
        got, segment.table_lookup_plain(ids_t, tab_t).numpy())


def test_table_lookup_checks_inputs():
    ids = torch.zeros((2, 64), dtype=torch.int32)
    tab = torch.zeros((2, 16, 5))
    with pytest.raises(TypeError):
        segment.table_lookup(ids.long(), tab)
    with pytest.raises(ValueError):
        segment.table_lookup(ids[:1], tab)
    with pytest.raises(ValueError):
        segment.table_lookup(ids.reshape(64, 2).T, tab)   # not contiguous


# ------------------------------------------------ B3's tile culling ----

def _boundary_cloud(radius, n_pairs=120, seed=7):
    """Pairs at d2 within a few ulps of radius^2 on both sides (d2 in the
    kernels' arithmetic), each point alone in its tile or with company
    inside the pair's span, the two points across a tile edge (slot 31 of
    one tile, slot 0 of the next) or tiles apart, with empty tiles and
    masked holes between. Returns (points (1, V, 3), maskf (1, V), the
    (row tile, column tile) of each pair alone in its two tiles)."""
    rng = np.random.default_rng(seed)
    t = tf.PAIR_TILE
    pts, msk, alone = [], [], []

    def tile(entries):
        """One tile from (slot, point, valid) entries, the rest masked."""
        block = np.zeros((t, 3), np.float32)
        ok = np.zeros(t, np.float32)
        for slot, p, v in entries:
            block[slot], ok[slot] = p, v
        pts.append(block)
        msk.append(ok)

    r = np.float64(radius)
    for k in range(n_pairs):
        a = rng.uniform(-6, 6, 3)
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        b = a + r * (1 + rng.integers(-3, 4) * 6e-8) * u
        a32, b32 = a.astype(np.float32), b.astype(np.float32)
        lo, hi = np.minimum(a32, b32), np.maximum(a32, b32)
        mid = ((lo + hi) / 2).astype(np.float32)
        company = k % 3 == 0          # points inside the pair's span
        hole = k % 4 == 1             # a masked point far away
        row = [(31, a32, 1.0)]
        col = [(0, b32, 1.0)]
        if company:
            row.append((5, np.clip(mid, lo, hi), 1.0))
            col.append((9, np.clip(mid, lo, hi), 1.0))
        if hole:
            row.append((12, a32 + 50.0, 0.0))
        tile(row)
        rt = len(pts) - 1
        if k % 5 == 2:                # tiles apart: an empty tile between
            tile([])
        tile(col)
        if not company:
            alone.append((rt, len(pts) - 1))
    return (torch.from_numpy(np.concatenate(pts))[None],
            torch.from_numpy(np.concatenate(msk))[None], alone)


def _random_cloud(seed, v=999):
    """Two clouds of clustered points with holes, a fully masked tile and
    a ragged last tile (V no multiple of 32)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-4, 4, (12, 3))
    pts = (centres[rng.integers(0, 12, (2, v))]
           + rng.normal(0, 0.6, (2, v, 3))).astype(np.float32)
    maskf = (rng.uniform(size=(2, v)) > 0.15).astype(np.float32)
    maskf[:, 64:96] = 0.0
    maskf[1, 900:] = 0.0
    return torch.from_numpy(pts), torch.from_numpy(maskf)


def _assert_culling_exact(points, maskf, radius):
    """Every valid pair with d2 <= r^2 (d2 as the kernels compute it) lies
    in a tile pair that tiles_in_radius passes; returns (in-radius pairs,
    tile pairs skipped, pairs at d2 == r^2)."""
    t = tf.PAIR_TILE
    bounds = tf.tile_bounds(points, maskf)
    ok_tiles = tf.tiles_in_radius(bounds, bounds, radius)
    r2 = tf._r2(radius, points)
    n_in = n_edge = 0
    for b in range(points.shape[0]):
        m = maskf[b] > 0
        _, d2 = tf._pair_geometry(points[b], points[b])
        near = (d2 <= r2) & m[:, None] & m[None, :]
        i, j = torch.nonzero(near, as_tuple=True)
        assert bool(ok_tiles[b, i // t, j // t].all())
        n_in += len(i)
        n_edge += int(((d2 == r2) & near).sum())
    return n_in, int((~ok_tiles).sum()), n_edge


def test_tile_bounds_are_the_valid_points_aabbs():
    """tile_bounds against numpy's min and max over each tile's valid
    points, [+inf, -inf] for the empty tiles, on a ragged last tile."""
    pts, maskf = _random_cloud(11)
    got = tf.tile_bounds(pts, maskf).numpy()
    t = tf.PAIR_TILE
    assert got.shape == (2, -(-pts.shape[1] // t), 8)
    for b in range(2):
        for k in range(got.shape[1]):
            p = pts[b, k * t:(k + 1) * t].numpy()
            m = maskf[b, k * t:(k + 1) * t].numpy() > 0
            if m.any():
                exp = np.concatenate([p[m].min(0), [0], p[m].max(0), [0]])
            else:
                exp = np.float32([np.inf] * 3 + [0] + [-np.inf] * 3 + [0])
            np.testing.assert_array_equal(got[b, k], exp)
    np.testing.assert_array_equal(
        tf.active_limit(maskf > 0).numpy(),
        [int(np.nonzero(maskf[b].numpy())[0].max()) + 1 for b in range(2)])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_tiles_in_radius_never_rejects_a_pair_in_radius(seed):
    """Random clustered clouds at B3's normal radius: no in-radius pair
    lies in a rejected tile pair, and the culling rejects some."""
    pts, maskf = _random_cloud(seed)
    n_in, skipped, _ = _assert_culling_exact(pts, maskf, 0.5)
    assert n_in > 1000 and skipped > 100


@pytest.mark.parametrize("seed", [1, 2])
def test_tiles_in_radius_never_rejects_a_pair_at_the_fpfh_radius(seed):
    """The same at B4's and B5's FPFH radius (0.75 m), where the culling
    keeps more tile pairs and still rejects some."""
    pts, maskf = _random_cloud(seed)
    n_in, skipped, _ = _assert_culling_exact(pts, maskf, 0.75)
    assert n_in > 1000 and skipped > 50


@pytest.mark.parametrize("radius", [0.5, 0.75, 0.85])
def test_tiles_in_radius_at_the_radius_boundary(radius):
    """Pairs at r and r +- a few ulps, across tile edges and tiles apart,
    alone in their tiles (the gap then is the pair's own offset, so the
    predicate is as tight as it gets) or with company, with empty tiles
    and masked holes: no in-radius pair is rejected, including those at
    d2 == r^2 exactly, and a pair alone in its tiles passes exactly when
    its d2 <= r^2 (the gap is taken in the distance's arithmetic)."""
    pts, maskf, alone = _boundary_cloud(radius)
    n_in, skipped, n_edge = _assert_culling_exact(pts, maskf, radius)
    assert n_edge > 0 and skipped > 0
    assert n_in > int((maskf > 0).sum())     # pairs beyond the self pairs
    t = tf.PAIR_TILE
    bounds = tf.tile_bounds(pts, maskf)
    ok_tiles = tf.tiles_in_radius(bounds, bounds, radius)[0]
    _, d2 = tf._pair_geometry(pts[0], pts[0])
    r2 = tf._r2(radius, pts)
    outside = 0
    for rt, ct in alone:
        inside = bool(d2[rt * t + 31, ct * t] <= r2)
        assert bool(ok_tiles[rt, ct]) == inside
        outside += not inside
    assert 0 < outside < len(alone)


# ------------------------------------------------------------------ B6 ---

def _split_merge_nn(desc_a, desc_b, maskf_a, maskf_b, sq_a, sq_b, width):
    """A plain model of csrc/nn1.cu's column splits, before the wrapper's
    fill: per batch entry, each split of ``width`` columns gives each row's
    first minimum over its columns (the distances of ``_chunk_d2`` under
    the active limits), and the splits merge by the least (d2, index),
    last split first (any order gives the same)."""
    bsz, na = desc_a.shape[:2]
    nb = desc_b.shape[1]
    lims = tf.nn_active_limits(maskf_a > 0, maskf_b > 0).tolist()
    outs = []
    for b in range(bsz):
        best_d = torch.full((na,), tf.FLT_MAX)
        best_i = torch.zeros(na, dtype=torch.int64)
        for c0 in reversed(range(0, nb, width)):
            d2 = tf._chunk_d2(desc_a, desc_b, maskf_a, maskf_b, sq_a, sq_b, b,
                              c0, min(width, nb - c0), lims[b])
            loc = torch.argmin(d2, dim=1)
            d, j = d2.gather(1, loc[:, None])[:, 0], loc + c0
            take = (d < best_d) | ((d == best_d) & (j < best_i))
            best_d = torch.where(take, d, best_d)
            best_i = torch.where(take, j, best_i)
        outs.append((best_i, best_d))
    idx, d2 = (torch.stack(t) for t in zip(*outs))
    return idx.to(torch.int32), d2


def _nn_masks(rng, na, nb, width):
    """Mask cases: A rows valid up to row 436 (a limit that is no multiple
    of any tile) with invalid rows scattered among them, B 90 % valid; the
    same with split 1 of ``width`` columns masked whole; B all masked."""
    ma = np.zeros(na, bool)
    ma[:437] = rng.uniform(size=437) > 0.2
    ma[[0, 1, 16, 17, 436]] = True
    mb = rng.uniform(size=nb) > 0.1
    cut = mb.copy()
    cut[width:2 * width] = False
    return {"ties": (ma, mb), "masked_split": (ma, cut),
            "no_column": (ma, np.zeros(nb, bool))}


def _plant_boundary_ties(da, db, width, mb):
    """A rows 0-1 copy column width - 1, which column width (the next
    split's first) equals; rows 16-17 copy column 2 width - 1, which 2
    width equals, where the columns exist: the first minimum is the lower
    side of each split boundary."""
    for r, j in ((0, width - 1), (16, 2 * width - 1)):
        if j + 1 < db.shape[0]:
            db[j + 1] = db[j]
            da[r:r + 2] = db[j]
            mb[[j, j + 1]] = True


@functools.lru_cache(maxsize=None)
def _pallas_nn(key):
    da, db, ma, mb = (np.frombuffer(b, dtype=t).reshape(s)
                      for b, t, s in key)
    return tuple(np.asarray(x) for x in jpf.nearest_neighbors_pallas(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb),
        interpret=True))


@pytest.mark.parametrize("nb", [1024, 2048])
@pytest.mark.parametrize("width", [32, 256, 1000])
def test_nearest_neighbors_split_merge_is_the_plain_version(width, nb):
    """B6's premise: the column splits' first minima merged by the least
    (d2, index), in reverse split order, equal ``nearest_neighbors_plain``
    bit for bit (index and d2; tolerance 0). Descriptors on an integer grid
    of 0-3 (exact distances with many equal minima among distinct columns)
    and with equal minima planted on both sides of split boundaries; a
    split masked whole; B all masked; an A row limit at 437. At Nb = 1024
    (Na = 512) the model, on 1/8-grid descriptors (exact distances), also
    equals the JAX package's Pallas 1-NN in interpret mode: indices and d2
    equal on every valid row with a valid column."""
    na = 512
    rng = np.random.default_rng(width * 7 + nb)
    grids = {"integer": lambda s: rng.integers(0, 4, s),
             "eighth": lambda s: rng.integers(0, 96, s) / 8.0}
    for grid, draw in grids.items():
        da = draw((na, 33)).astype(np.float32)
        db = draw((nb, 33)).astype(np.float32)
        for case, (ma, mb) in _nn_masks(rng, na, nb, width).items():
            ma, mb, a_np, b_np = ma.copy(), mb.copy(), da.copy(), db.copy()
            if case == "ties":
                _plant_boundary_ties(a_np, b_np, width, mb)
            a, b = torch.from_numpy(a_np)[None], torch.from_numpy(b_np)[None]
            mfa = torch.from_numpy(ma)[None].float()
            mfb = torch.from_numpy(mb)[None].float()
            sq_a, sq_b = (a * a).sum(-1), (b * b).sum(-1)
            idx, d2 = _split_merge_nn(a, b, mfa, mfb, sq_a, sq_b, width)
            ridx, rd2 = tf.nearest_neighbors_plain(a, b, mfa, mfb, sq_a, sq_b)
            assert torch.equal(idx, ridx), (grid, case)
            assert torch.equal(d2, rd2), (grid, case)
            if case == "ties" and width < nb:
                assert int(idx[0, 0]) <= width - 1
                assert float(d2[0, 0]) == 0.0
            if case == "no_column":
                assert (d2 == tf.FLT_MAX).all() and (idx == 0).all()
            if grid == "eighth" and case != "no_column" and nb == 1024:
                key = tuple((x.tobytes(), x.dtype.str, x.shape)
                            for x in (a_np, b_np, ma, mb))
                pal_i, pal_d = _pallas_nn(key)
                row = torch.from_numpy(ma)
                np.testing.assert_array_equal(idx[0][row].numpy(),
                                              pal_i[ma])
                np.testing.assert_array_equal(d2[0][row].numpy(), pal_d[ma])


# ----------------------------------------------------------- launchers --

def _c_launchers():
    """{symbol: (source stem, [parameter declarations])} of every
    ``extern "C"`` function in csrc/*.cu."""
    from quatro_tpu_torch import _build
    out = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C"\s+int\s+(\w+)\s*\(([^)]*)\)',
                             path.read_text()):
            out[m.group(1)] = (path.stem, [p.strip()
                                           for p in m.group(2).split(",")])
    return out


def _launcher_entries():
    from quatro_tpu_torch import _build
    entries = {k: (k, *v) for k, v in _build.SIGNATURES.items()}
    entries.update(_build.EXTRA)
    return entries


@pytest.mark.parametrize("name", sorted(_launcher_entries()))
def test_launcher_signature_matches_its_c_function(name):
    """Each ctypes signature in ``_build.SIGNATURES`` / ``EXTRA`` names a
    function of its source and gives each C parameter its type: a pointer
    or the stream as c_void_p, an int as c_int, a float as c_float (ctypes
    cannot see the C side: a wrong or missing type there passes a bad
    pointer or value to the card, or shifts the arguments after it)."""
    import ctypes
    source, symbol, argtypes = _launcher_entries()[name]
    launchers = _c_launchers()
    assert symbol in launchers, symbol
    stem, params = launchers[symbol]
    assert stem == source

    def ctype(param):
        if "*" in param or param.split()[0] == "cudaStream_t":
            return ctypes.c_void_p
        return {"int": ctypes.c_int, "float": ctypes.c_float}[
            param.split()[0]]

    assert [ctype(p) for p in params] == list(argtypes), params
