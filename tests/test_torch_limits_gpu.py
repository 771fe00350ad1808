"""The kernels' wide routes on the card: each at its first size past the
limit of its first design, bit for bit its plain version on the card, its
route counted in ``ops.launch.SIZE_ROUTES`` ("past"). The inputs are
tests/torch_limit_cases.py's; on the CPU the plain versions are held
against the JAX package at the same sizes (tests/test_torch_limits.py).

Every test is marked ``gpu`` and skips without a CUDA device; the machine
with the card has no JAX, so this file imports only the port:

    python -m pytest --noconftest -m gpu tests/test_torch_limits_gpu.py
"""

import contextlib
import dataclasses

import pytest
import torch

from quatro_tpu_torch.config import PipelineConfig
from quatro_tpu_torch.io.synthetic import make_scan_pair
from quatro_tpu_torch.ops import cliques as tcl
from quatro_tpu_torch.ops import czm, launch, polish, segment
from quatro_tpu_torch.ops import ground as og
from quatro_tpu_torch.ops import icp as ticp
from quatro_tpu_torch.ops.neighbors import (radius_neighbors,
                                            radius_neighbors_plain)
from quatro_tpu_torch.ops.normals import (estimate_normals,
                                          estimate_normals_plain)
from quatro_tpu_torch.preprocessing import patchwork
from quatro_tpu_torch.solver import vote
from quatro_tpu_torch.utils import loops

import torch_limit_cases as lc
from torch_icp_cases import correspond_args, dof_of, icp_clouds
from torch_polish_cases import (plain_polish_route, same_bits,
                                solution_fields, solve_case)
from torch_vote_level_cases import GROUND_CONFIG

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@contextlib.contextmanager
def routes():
    """The wrappers' route counts over the block, from zero."""
    launch.reset_launches()
    counts = launch.SIZE_ROUTES
    yield counts
    torch.cuda.synchronize()


def _bits(a, b):
    return all(same_bits(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------- the polish --

@pytest.mark.parametrize("n", [lc.POLISH_N, 8192])
@pytest.mark.parametrize("opts", [{}, dict(rotation_estimation_algorithm="FGR",
                                           cote_mode="weighted_mean")],
                         ids=["gnc_tls", "fgr"])
def test_polish_wide_rows(dev, n, opts):
    """The chain, the yaw GNC and COTE at N past 4096 points a row: the
    chain's order and COTE's events in a global workspace, the GNC's
    points folded from global memory; every field of the solve bit for
    bit the plain route's on the card."""
    case = lc.polish_case(n, opts)
    with routes() as r:
        got = solution_fields(solve_case(case, dev))
    assert {k: r[k]["past"] for k in ("polish_chain", "gnc_yaw",
                                      "polish_cote")} == {
        "polish_chain": 1, "gnc_yaw": 1, "polish_cote": 1}
    with plain_polish_route(), loops.eager_loops():
        ref = solution_fields(solve_case(case, dev))
    assert _bits(got, ref)


def test_cote_on_given_points_wide(dev):
    """COTE on given points (solve_translation) at 4097 points a row."""
    case = lc.polish_case(lc.POLISH_N)
    src, tgt = case["src"].to(dev), case["tgt"].to(dev)
    mask = case["clique"][:, 1].to(dev).contiguous()
    with routes() as r:
        got = polish.cote_translation(src, tgt, mask, 0.3, 1.0, True)
    assert r["polish_cote"]["past"] == 1
    assert _bits(got, polish.cote_translation_plain(src, tgt, mask, 0.3, 1.0,
                                                    True))


# -------------------------------------------------------------------- ICP --

@pytest.mark.parametrize("rows", [lc.ICP_ROWS, 16385])
def test_icp_update_wide(dev, rows):
    """The update over 8193 source rows (a fold of 16 leaves a thread in
    registers) and 16385 (a fold of 32, by the strided fold) bit for bit
    its plain version on the card, both pairs and both DoF masks."""
    vox, vmask, gt, cfg = icp_clouds(dev)
    f = cfg.fpfh
    nb = radius_neighbors(vox[1], vmask[1], f.normal_radius,
                          f.max_neighbors_normal)
    normals = estimate_normals(vox[1], nb)
    args = correspond_args(vox.cpu(), vmask.cpu(), normals.normals.cpu(),
                           normals.valid.cpu(), gt, cfg, device=dev)
    src, smask = lc.wide_source(vox.cpu(), vmask.cpu(), rows)
    args = (src[None].expand(2, -1, -1).contiguous().to(dev),
            smask[None].expand(2, -1).contiguous().to(dev)) + args[2:]
    step = torch.zeros(1, dtype=torch.int64, device=dev)
    rows, ok = ticp.icp_correspond(*args, step, cfg.icp.huber_delta)
    for yaw_only in (False, True):
        dof = dof_of(yaw_only).to(dev)
        with routes() as r:
            got = ticp.icp_update(rows, ok, args[2], args[3], step, dof,
                                  cfg.icp.damping, cfg.icp.min_correspondences)
        assert r["icp_update"]["past"] == 1
        ref = ticp.icp_update_plain(rows, ok, args[2], args[3], step, dof,
                                    cfg.icp.damping,
                                    cfg.icp.min_correspondences)
        assert _bits(got, ref)


# ---------------------------------------------- neighbour lists, normals --

@pytest.mark.parametrize("k", [*lc.LIST_WIDTHS_PAST, 200, 257])
def test_neighbor_lists_and_normals_wide(dev, k):
    """The lists at K past two slots a lane (4 and 8 slots, and the block
    route past 256) and their normals (a lane's slots by the strided
    fold), both clouds in one call, bit for bit the plain versions on
    the card."""
    vox, vmask, _, cfg = icp_clouds(dev)
    r2 = cfg.fpfh.normal_radius
    with routes() as r:
        got = radius_neighbors(vox, vmask, r2, k)
    assert r["radius_knn"]["past"] == 1
    ref = radius_neighbors_plain(vox, vmask, r2, k)
    assert _bits(got, ref)
    with routes() as r:
        n_got = estimate_normals(vox, got)
    assert r["neighbor_normals"]["past"] == 1
    assert _bits(n_got, estimate_normals_plain(vox, got))


# --------------------------------------------------------------- the CZM --

def test_czm_nine_zones_and_patchwork(dev):
    """czm_points with a nine-zone table (read from the card's memory)
    bit for bit its plain version on an HDL-64E pair, and Patchwork's
    whole estimate_ground at that table (B8, B9, B10, seed heights and
    plane fits at its larger patch count) equal to the route with the
    three CZM-stage kernels swapped for their plain versions."""
    src, tgt, _ = make_scan_pair(seed=11, yaw_deg=20.0,
                                 translation=(2.5, 1.0, 0.05))
    n = 131072
    pts = torch.zeros(2, n, 3)
    mask = torch.zeros(2, n, dtype=torch.bool)
    for b, xyz in enumerate((src, tgt)):
        xyz = xyz[:n]
        pts[b, :len(xyz)], mask[b, :len(xyz)] = torch.from_numpy(xyz), True
    pts, mask = pts.to(dev), mask.to(dev)
    cfg = dataclasses.replace(PipelineConfig().patchwork, **lc.NINE_ZONES)
    with routes() as r:
        got = czm.czm_points(pts, mask, cfg)
    assert r["czm_points"]["past"] == 1
    assert _bits(got, czm.czm_points_plain(pts, mask, cfg))
    ground = patchwork.estimate_ground(pts, mask, cfg)
    saved = {k: getattr(patchwork, k) for k in ("czm_points", "seed_heights",
                                                "plane_fit")}
    try:
        for k in saved:
            setattr(patchwork, k, getattr(czm, f"{k}_plain"))
        with loops.eager_loops():
            ref = patchwork.estimate_ground(pts, mask, cfg)
    finally:
        for k, fn in saved.items():
            setattr(patchwork, k, fn)
    for name, g, r_ in zip(ground._fields, ground, ref):
        assert same_bits(g, r_), name
    assert int(ground.ground.sum()) > 10000


# -------------------------------------------------------------------- B8 --

@pytest.mark.parametrize("name", list(lc.HIST_SHAPES))
def test_cross_histogram_tiles(dev, name):
    """Five channels, and 768 columns of two: the histogram in tiles of
    channels and columns, bit for bit the plain version on CPU copies."""
    ia, ib, w, a_pad, b_pad = lc.histogram_inputs(name)
    with routes() as r:
        got = segment.cross_histogram(ia.to(dev), ib.to(dev), w.to(dev),
                                      a_pad, b_pad)
    assert r["cross_histogram"]["past"] == 1
    assert launch.LAUNCHES["cross_histogram"] == 1
    assert torch.equal(got.cpu(), segment.cross_histogram_plain(
        ia, ib, w, a_pad, b_pad))


# --------------------------------------------------------- the leveling --

def test_ground_fit_wide(dev):
    """A cloud of 2^18 + 1 points (its strided sets past 32 points a
    thread), alone and as a pair with its reversed copy, bit for bit the
    plain version on the card."""
    pts, mask = (t.to(dev)[None] for t in lc.ground_cloud())
    other = (pts.flip(1).contiguous(), mask.flip(1).contiguous())
    for pair in (None, other):
        with routes() as r:
            got = og.ground_fit(pts, mask, GROUND_CONFIG, other=pair)
        assert r["ground_fit"]["past"] == 1
        assert _bits(got, og.ground_fit_plain(pts, mask, GROUND_CONFIG,
                                              other=pair))
        assert bool(got[2].all())


# ---------------------------------------------------------- the growth --

@pytest.mark.parametrize("n,missing", [(4352, ()), (lc.ROUNDING_N,
                                                    lc.ROUNDING_MISSING),
                                       (lc.GROW_WIDE_N, ())],
                         ids=["complete_4352", "rounding_6144",
                              "complete_20000"])
def test_grow_cliques_past_the_exact_limit(dev, n, missing):
    """The growth at N past 4096 with max_size N + 1: a complete graph
    (every seed absorbs its candidates whole), the graph whose f32 test
    absorbs a non-clique in the JAX package (the port's exact counts grow
    it vertex by vertex), and a complete graph of 20000 vertices (past the
    first design's shared memory; the redesign's bits sit in shared memory
    at any N): the kernel bit for bit the plain route on the card, and a
    clique."""
    adj, scores, mask = (t.to(dev) for t in lc.complete_graph(n, missing))
    _, core, deg, packed = tcl.kcore_search(adj, mask)
    with routes() as r:
        got = tcl.grow_cliques(adj, scores, mask, 1, n + 1, 8, 16, packed)
    assert r["grow_cliques"]["past"] == 1
    with loops.eager_loops():
        ref = tcl.grow_cliques_plain(adj, scores, mask, 1, n + 1, 8, 16)
    assert torch.equal(got, ref)
    members = got[0, 0]
    sub = adj[0][members][:, members]
    k = int(members.sum())
    assert int(sub.sum()) == k * (k - 1)
    assert k == (n if not missing else n - 1)


# ------------------------------------------- the reference's own limits --

def test_vote_past_2048_refused_on_the_card(dev):
    """The translation vote's 2N ranks in 12 bits: N = 2304 refused on the
    card as on the CPU and in the JAX package."""
    n = 2304
    z = torch.zeros((n, 3), device=dev)
    with pytest.raises(ValueError, match="2048"):
        vote.vote_hypotheses(z, z + 0.05, torch.ones(n, dtype=torch.bool,
                                                     device=dev),
                             torch.zeros((n, n), dtype=torch.bool, device=dev),
                             torch.tensor(1.0, device=dev), 2, 1.0)


def _layout_fits(rows, cols):
    """The labelling kernel's fit rule (csrc/label_sweep.cu::choose_layout)
    on the host: a cluster of the largest power of two up to 16 CTAs and
    at most the row count holds ceil(rows / cluster) rows a CTA at 10
    bytes a pixel within 226 KB; an image that fits none takes the global
    route."""
    cs = 16
    while cs > rows and cs > 1:
        cs //= 2
    return -(-rows // cs) * cols * 10 <= 226 * 1024


def test_label_layout_over_the_references_images(dev):
    """Every image of at most 2^17 - 1 pixels that the JAX projection
    takes, at each row count from 1 to 128 at its widest, has a layout:
    the named shapes (64 x 2047, 128 x 1023, 16 x 8191) and every image of
    12 or more rows in a cluster's shared memory; narrower ones of more
    than ~23k pixels a row in the global workspace (the host rule says
    which, and label_layout agrees on each)."""
    from quatro_tpu_torch.ops.labels import label_layout
    top = (1 << 17) - 1
    for rows, cols in ((64, 2047), (128, 1023), (16, 8191)):
        assert label_layout(1, rows, cols)["image_in"] == "shared"
    wide = []
    for rows in range(1, 129):
        cols = top // rows
        lay = label_layout(1, rows, cols)
        assert lay["resident_clusters"] >= 1
        assert (lay["image_in"] == "shared") == _layout_fits(rows, cols), (
            rows, cols, lay)
        if lay["image_in"] == "global":
            wide.append(rows)
            assert lay["cluster"] <= min(8, rows)
    assert wide and all(r < 12 for r in wide), wide


@pytest.mark.parametrize("mode", ["4CrossNeighbor", "8Neighbor"])
@pytest.mark.parametrize("rows,cols", lc.NARROW_IMAGES)
def test_label_sweeps_narrow_wide_images(dev, rows, cols, mode):
    """The labelling of the narrow wide images the JAX projection takes and
    no cluster's shared memory holds (1 x 131071, 4 x 32767, 11 x 11915),
    under the projection's sweep schedule: the global route, counted
    "past", labels and rounds bit for bit the plain route on the card."""
    from quatro_tpu_torch.ops.labels import (label_layout, label_sweeps,
                                             label_sweeps_plain)
    labels, valid, masks, *rest = lc.narrow_labelling(rows, cols, mode)
    args = (labels.to(dev), valid.to(dev), [m.to(dev) for m in masks],
            *rest)
    assert label_layout(2, rows, cols)["image_in"] == "global"
    with routes() as r:
        got = label_sweeps(*args)
    assert r["label_sweep"] == {"within": 0, "past": 1}
    with loops.eager_loops():
        ref = label_sweeps_plain(*args)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    print(rows, cols, mode, "rounds", got[1].tolist())
