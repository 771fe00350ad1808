"""The polish (ops/polish.py: chain TIMs, the yaw GNC, COTE) on the CPU:
each plain piece against its JAX function, the whole of
``_solve_from_inliers`` against ``jax.vmap`` of the JAX package's, and the
composition of the plain pieces bit for bit the route before the kernels
(tests/torch_polish_cases.py keeps its arithmetic) on every case. Host
walks of the kernels' tree sum and event order hold their design against
the plain operations.
"""

import dataclasses
import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.solver import quatro as jquatro
from quatro_tpu.solver import rotation as jrot
from quatro_tpu.solver import translation as jtrans
from quatro_tpu.io.synthetic import make_correspondences

from quatro_tpu_torch.ops import polish
from quatro_tpu_torch.solver import rotation as trot
from quatro_tpu_torch.solver import translation as ttrans
from quatro_tpu_torch.utils.fused import pairwise_sum

import torch_polish_cases as pc

SOLVER_FIXTURES = [(0, 100), (1, 40), (2, 15), (3, 5)]  # test_torch_solver
N = 500


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_config(config):
    fields = {f.name for f in dataclasses.fields(jcfg.SolverConfig)}
    kw = {k: v for k, v in dataclasses.asdict(config).items() if k in fields}
    kw["use_pallas_graph"] = False
    return jcfg.SolverConfig(**kw)


def _fixture_tims(seed, n_in):
    """The chain TIMs of a solver fixture's true inliers (the last seven
    slots masked off): src, tgt (1, N, 3), the chain's outputs (1, 1, ...)."""
    src, tgt, _, inl = make_correspondences(
        seed=seed, n_inliers=n_in, n_outliers=N - n_in, yaw_deg=63.0,
        translation=(4.0, -2.5, 0.4))
    inl = inl & (np.arange(N) < N - 7)
    src, tgt = torch.from_numpy(src)[None], torch.from_numpy(tgt)[None]
    clique = torch.from_numpy(inl)[None, None]
    return src, tgt, polish.polish_chain_plain(
        src, tgt, clique, torch.ones(1, 1), torch.eye(3), False)


# ------------------------------------------------------------ the pieces --

@pytest.mark.parametrize("name", ["batch3", "n1024", "noise_free"])
def test_chain_order_matches_jax(name):
    case = pc.polish_case(name)
    order, leaf, chain, m, _, _ = polish.polish_chain_plain(
        case["src"], case["tgt"], case["clique"], case["scale"],
        case["prior"], case["has_prior"])
    ref = jax.vmap(jax.vmap(jquatro._chain_order))(
        jnp.asarray(case["clique"].numpy()))
    for got, want in zip((order, leaf, chain, m), ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("algorithm", ["GNC_TLS", "FGR"])
@pytest.mark.parametrize("seed,n_in", SOLVER_FIXTURES)
def test_gnc_yaw_matches_jax(seed, n_in, algorithm):
    _, _, (_, _, chain, _, st, dt) = _fixture_tims(seed, n_in)
    got = trot.gnc_rotation_2d(st[..., :2], dt[..., :2], chain, 0.6,
                               algorithm=algorithm)
    ref = jrot.gnc_rotation_2d(jnp.asarray(st[0, 0, :, :2].numpy()),
                               jnp.asarray(dt[0, 0, :, :2].numpy()),
                               jnp.asarray(chain[0, 0].numpy()), 0.6,
                               algorithm=algorithm)
    np.testing.assert_allclose(got.rotation[0, 0].numpy(),
                               np.asarray(ref.rotation), atol=1e-4)
    np.testing.assert_array_equal(got.inlier_mask[0, 0].numpy(),
                                  np.asarray(ref.inlier_mask))
    assert int(got.iterations[0, 0]) == int(ref.iterations)


@pytest.mark.parametrize("use_median", [True, False])
@pytest.mark.parametrize("seed,n_in", SOLVER_FIXTURES)
def test_cote_matches_jax(seed, n_in, use_median):
    src, tgt, gt, inl = make_correspondences(
        seed=seed, n_inliers=n_in, n_outliers=N - n_in, yaw_deg=63.0,
        translation=(4.0, -2.5, 0.4))
    rotated = (src @ gt[:3, :3].T).astype(np.float32)
    mask = inl | (np.random.default_rng(seed).uniform(size=N) < 0.05)
    got = ttrans.solve_translation(torch.from_numpy(rotated),
                                   torch.from_numpy(tgt),
                                   torch.from_numpy(mask), 0.3, 1.0,
                                   use_median)
    ref = jtrans.solve_translation(jnp.asarray(rotated), jnp.asarray(tgt),
                                   jnp.asarray(mask), 0.3, 1.0, use_median)
    np.testing.assert_allclose(got.translation.numpy(),
                               np.asarray(ref.translation), atol=1e-3)
    np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                  np.asarray(ref.inlier_mask))


@pytest.mark.parametrize("use_median", [True, False])
def test_cote_ties_match_jax(use_median):
    """Events tied at one value and at -0.0 / +0.0 (a noise bound of 0):
    the plain COTE against the JAX package's, row by row."""
    src, dst, mask = pc.cote_tie_case()
    for nb in (0.0, 0.3):
        got = ttrans.solve_translation(src, dst, mask, nb, 1.0, use_median)
        for r in range(src.shape[0]):
            ref = jtrans.solve_translation(
                jnp.asarray(src[r].numpy()), jnp.asarray(dst[r].numpy()),
                jnp.asarray(mask[r].numpy()), nb, 1.0, use_median)
            np.testing.assert_allclose(got.translation[r].numpy(),
                                       np.asarray(ref.translation),
                                       atol=1e-3)
            np.testing.assert_array_equal(got.inlier_mask[r].numpy(),
                                          np.asarray(ref.inlier_mask))


def test_cpu_sort_ranks_signed_zeros_by_index():
    """The plain COTE's stable sort on the CPU keeps -0.0 and +0.0 in
    index order (they compare equal), the order the card's radix sort
    gives them (cub ranks -0.0 as +0.0); the kernel's keys
    (``_ordered_bits``) order them so too."""
    values = torch.tensor([0.0, -0.0, 1.0, -0.0, 0.0, -1.0, -0.0])
    order = torch.sort(values, stable=True).indices
    assert order.tolist() == [5, 0, 1, 3, 4, 6, 2]
    keys = [(_ordered_bits(float(v)), i) for i, v in enumerate(values)]
    assert [i for _, i in sorted(keys)] == order.tolist()


# ------------------------------------------------------------- the whole --

def _jax_solve(case):
    cfg = _jax_config(case["config"])
    has_prior = case["has_prior"]
    per_pair = case["prior"].dim() == 3

    def one(src, tgt, clique, valid, scale, prior):
        return jquatro._solve_from_inliers(src, tgt, clique, valid, scale,
                                           cfg, prior, has_prior)

    rows = jax.vmap(one, in_axes=(None, None, 0, 0, 0, None))
    fn = jax.jit(jax.vmap(rows, in_axes=(0, 0, 0, 0, 0,
                                         0 if per_pair else None)))
    return fn(*(jnp.asarray(case[k].numpy()) for k in
                ("src", "tgt", "clique", "valid", "scale", "prior")))


@pytest.mark.parametrize("name", ["batch3", "fgr", "prior", "prior_one",
                                  "rot_inliers", "scaling", "noise_free",
                                  "max_iter0", "max_iter1", "max_iter3"])
def test_solve_from_inliers_matches_jax(name):
    """Every valid row against ``jax.vmap`` of the JAX package's polish at
    tests/test_torch_solver.py's tolerances (rotation 1e-4, translation
    1e-3, valid and the rotation inliers' count exactly): the rows with the
    true inliers of the two real pairs, where both recover the motion."""
    case = pc.polish_case(name)
    got = pc.solve_case(case)
    ref = _jax_solve(case)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    for b in (0, 1):
        for h in (0, 1):
            np.testing.assert_allclose(got.rotation[b, h].numpy(),
                                       np.asarray(ref.rotation[b, h]),
                                       atol=1e-4)
            np.testing.assert_allclose(got.translation[b, h].numpy(),
                                       np.asarray(ref.translation[b, h]),
                                       atol=1e-3)
            assert (int(got.num_rotation_inliers[b, h])
                    == int(ref.num_rotation_inliers[b, h]))
    # rows without a valid selection: the identity and no translation
    off = ~got.valid
    assert torch.equal(got.rotation[off], torch.eye(3).expand(
        int(off.sum()), 3, 3))
    assert not got.translation[off].any()
    assert not got.final_inlier_mask[off].any()


def test_teaser_matches_jax():
    case = pc.polish_case("teaser")
    got = pc.solve_case(case)
    ref = _jax_solve(case)
    for b in (0, 1):
        np.testing.assert_allclose(got.rotation[b, 0].numpy(),
                                   np.asarray(ref.rotation[b, 0]), atol=1e-4)
        np.testing.assert_allclose(got.translation[b, 0].numpy(),
                                   np.asarray(ref.translation[b, 0]),
                                   atol=1e-3)


@pytest.mark.parametrize("name", list(pc.CASES))
def test_plain_pieces_equal_former_route(name):
    """The composition of the plain pieces (the CPU's route) is the route
    before the kernels bit for bit: every field of every row."""
    case = pc.polish_case(name)
    got = pc.solve_case(case)
    ref = pc.former_solve_from_inliers(
        case["src"], case["tgt"], case["clique"], case["valid"],
        case["scale"], case["config"], case["prior"], case["has_prior"])
    for f, a, b in zip(dataclasses.fields(got), pc.solution_fields(got),
                       pc.solution_fields(ref)):
        assert pc.same_bits(a, b), f.name
    if name == "nan":
        # a NaN reaches every row of its pair (the TIMs past a chain are
        # (a - b) * 0), as in the JAX package, and no other pair
        assert torch.isnan(got.gnc_cost[0]).all()
        assert torch.isfinite(got.gnc_cost[2]).all()


def test_rows_stop_on_their_own():
    """The cases' GNC rows end at iteration 0 (no valid correspondence,
    one point, the noise-free stop), early, and at the bound."""
    iters = pc.solve_case(pc.polish_case("noise_free")).gnc_iterations
    assert int(iters[0, 0]) == 1 and int(iters[0, 4]) == 1
    assert int(iters.max()) > 10
    capped = pc.solve_case(pc.polish_case("max_iter3")).gnc_iterations
    assert int(capped.max()) == 3 and int(capped.min()) == 1
    assert not pc.solve_case(pc.polish_case("max_iter0")).gnc_iterations.any()


def test_solve_translation_routes_through_wrapper():
    src, dst, mask = pc.cote_tie_case()
    got = ttrans.solve_translation(src, dst, mask, 0.3)
    ref = ttrans.solve_translation_plain(src, dst, mask, 0.3)
    assert torch.equal(got.translation, ref.translation)
    assert torch.equal(got.inlier_mask, ref.inlier_mask)


def test_wrappers_check_their_inputs():
    case = pc.polish_case("batch3")
    with pytest.raises(ValueError):
        polish.polish_chain(case["src"], case["tgt"], case["clique"][0],
                            case["scale"], case["prior"], False)
    with pytest.raises(ValueError):
        polish.polish_chain(case["src"], case["tgt"], case["clique"],
                            case["scale"][:, :2], case["prior"], False)
    with pytest.raises(ValueError):
        trot.gnc_rotation_2d(case["src"][..., :2], case["tgt"][..., :2],
                             case["clique"][:, 0], 0.3, algorithm="SVD")
    with pytest.raises(ValueError):      # the yaw kernel takes the card's
        polish.gnc_yaw(case["src"][..., :2], case["tgt"][..., :2],
                       case["clique"][:, 0], 0.3)


# -------------------------------------------- host walks of the kernels --

def _ordered_bits(v: float) -> int:
    """csrc/polish.cu's ordered_bits of a stable sort: cub's
    order-preserving bits of an f32, -0.0 ranked as +0.0."""
    u = struct.unpack("<I", struct.pack("<f", v))[0]
    if u == 0x80000000:
        u = 0
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def _tree_walk(x: np.ndarray, threads: int, npt: int) -> np.float32:
    """csrc/polish.cu's tree_sum on the host: point i at thread i %
    threads, slot i // threads; the levels at or above `threads` inside a
    thread, then shared memory down to 32 entries, then warp shuffles."""
    n = x.shape[0]
    p = 1 << max(0, (n - 1).bit_length())
    assert p <= threads * npt
    v = np.zeros((npt, threads), np.float32)
    for i in range(n):
        v[i // threads, i % threads] = x[i]
    half = p // 2
    h = npt // 2
    while h >= 1:
        if h * threads <= half:
            for k in range(h):
                v[k] = v[k] + v[k + h]
        h //= 2
    half = min(half, threads // 2)
    lane = v[0].copy()
    while half >= 1:                    # shared levels and shuffles alike
        lane[:half] = lane[:half] + lane[half:2 * half]
        half //= 2
    return lane[0]


@pytest.mark.parametrize("n", [1, 2, 3, 31, 33, 255, 257, 500, 1024, 1500,
                               4096])
def test_tree_walk_equals_pairwise_sum(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)).astype(
        np.float32)
    want = pairwise_sum(torch.from_numpy(x)).numpy()
    p = 1 << max(0, (n - 1).bit_length())
    threads, npt = ((256, max(1, p // 256)) if p <= 1024
                    else (1024, p // 1024))
    assert np.float32(_tree_walk(x, threads, npt)).tobytes() == \
        want.tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_event_keys_order_as_the_stable_sort(seed):
    """COTE's (ordered bits, index) keys sort the 2N events as
    torch.sort(stable=True) on the CPU does: ties at one value, signed
    zeros and the masked events' FLT_MAX last in index order."""
    rng = np.random.default_rng(seed)
    v = rng.choice(np.array([-1.5, -0.0, 0.0, 0.25, 2.0,
                             np.finfo(np.float32).max], np.float32), 64)
    order = torch.sort(torch.from_numpy(v), stable=True).indices.tolist()
    keys = sorted((_ordered_bits(float(x)), i) for i, x in enumerate(v))
    assert [i for _, i in keys] == order


@functools.lru_cache(maxsize=None)
def _solver_case_tims():
    return [_fixture_tims(s, k) for s, k in SOLVER_FIXTURES]


def test_gnc_yaw_plain_takes_strided_tims():
    """The GNC on the TIMs' xy view (a point stride of 3) and on a
    contiguous copy: the same bits (the kernel takes the view's strides)."""
    for _, _, (_, _, chain, _, st, dt) in _solver_case_tims():
        a = trot.gnc_rotation_2d(st[..., :2], dt[..., :2], chain, 0.6)
        b = trot.gnc_rotation_2d(st[..., :2].contiguous(),
                                 dt[..., :2].contiguous(), chain, 0.6)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
