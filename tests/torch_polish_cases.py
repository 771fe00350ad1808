"""The hypothesis rows that the polish's kernels (quatro_tpu_torch/ops/
polish.py, csrc/polish.cu) are held on: against the JAX package and the
route before the kernels on the CPU (tests/test_torch_polish_kernels.py)
and against their plain versions on the card (tests/
test_torch_kernels_gpu.py, chip_smoke.py). Imports no JAX.

A case is src, tgt (B, N, 3), one selection a hypothesis row (B, H, N),
valid and scale (B, H), the prior (3, 3) or (B, 3, 3) and the solver
options it runs under."""

import contextlib
import dataclasses

import numpy as np
import torch

from quatro_tpu_torch.config import SolverConfig
from quatro_tpu_torch.io.synthetic import make_correspondences
from quatro_tpu_torch.utils.batch import gather_rows
from quatro_tpu_torch.utils.se3 import rotate_points, rotation_from_rpy

ROLL_PITCH = (0.04, -0.03)
# name -> (N, solver options, prior: None / "one" / "pairs", noise-free)
CASES = {
    "batch3": (500, {}, None, False),
    "n1024": (1024, {}, None, False),
    "fgr": (500, dict(rotation_estimation_algorithm="FGR"), None, False),
    "max_iter0": (500, dict(rotation_max_iterations=0), None, False),
    "max_iter1": (500, dict(rotation_max_iterations=1), None, False),
    "max_iter3": (500, dict(rotation_max_iterations=3), None, False),
    "prior": (500, {}, "pairs", False),
    "prior_one": (500, dict(cote_mode="weighted_mean"), "one", False),
    "rot_inliers": (500, dict(using_rot_inliers_when_estimating_cote=True),
                    None, False),
    "scaling": (500, dict(estimate_scaling=True), None, False),
    "teaser": (500, dict(reg_name="TEASER"), None, False),
    "noise_free": (500, {}, None, True),
    "nan": (500, {}, None, False),
}


def _pair(seed, n, n_in, noise, roll_pitch):
    if n_in == 0:                       # a junk pair: no consistent motion
        rng = np.random.default_rng(seed)
        src, tgt = (rng.uniform(-30, 30, (n, 3)).astype(np.float32)
                    for _ in range(2))
        return src, tgt, np.zeros(n, bool)
    src, tgt, _, inl = make_correspondences(
        seed=seed, n_inliers=n_in, n_outliers=n - n_in, yaw_deg=63.0,
        translation=(4.0, -2.5, 0.4), noise_std=noise,
        roll_pitch=roll_pitch)
    return src, tgt, inl


def _rows(inl, mask, rng):
    """Six selections of one pair: the true inliers, the inliers and a
    few outliers, every valid slot (mostly outliers), three random
    slots, none (no valid correspondence) and one slot."""
    n = mask.shape[0]
    some = inl | (rng.uniform(size=n) < 0.03)
    three = np.zeros(n, bool)
    three[rng.choice(np.flatnonzero(mask), 3, replace=False)] = True
    one = np.zeros(n, bool)
    one[np.flatnonzero(mask)[0]] = True
    return np.stack([inl, some, mask.copy(), three, np.zeros(n, bool),
                     one]) & mask


def polish_case(name):
    """The case's tensors on the CPU and its solver configuration: a dict
    with src, tgt, clique (B, H, N), valid, scale (B, H), prior, has_prior,
    config. Three pairs (80 and 40 inliers, a junk pair), six rows each;
    the last seven slots of each pair masked off. The "nan" case puts a
    NaN in the source of the first pair's first true inlier and in the
    target of the second's."""
    n, opts, prior_kind, noise_free = CASES[name]
    rng = np.random.default_rng(7)
    rp = ROLL_PITCH if prior_kind else (0.0, 0.0)
    noise = 0.0 if noise_free else 0.05
    srcs, tgts, rows = [], [], []
    for seed, n_in in ((0, 80), (1, 40), (2, 0)):
        src, tgt, inl = _pair(seed, n, n_in, noise, rp)
        mask = np.arange(n) < n - 7
        srcs.append(src)
        tgts.append(tgt)
        rows.append(_rows(inl & mask, mask, rng))
    if name == "nan":
        for b, xyz in ((0, srcs), (1, tgts)):
            xyz[b] = xyz[b].copy()
            xyz[b][np.flatnonzero(rows[b][0])[0], b + 1] = np.nan
    clique = torch.from_numpy(np.stack(rows))
    b = clique.shape[0]
    scale = torch.ones(clique.shape[:2])
    if opts.get("estimate_scaling"):
        scale = torch.from_numpy(rng.uniform(0.97, 1.03, b).astype(
            np.float32))[:, None].expand(clique.shape[:2]).contiguous()
    prior = torch.eye(3)
    if prior_kind:
        ry_rx = rotation_from_rpy(*ROLL_PITCH, 0.0)
        prior = (ry_rx if prior_kind == "one" else
                 torch.stack([ry_rx, rotation_from_rpy(0.01, 0.02, 0.0),
                              torch.eye(3)]))
    return dict(src=torch.from_numpy(np.stack(srcs)),
                tgt=torch.from_numpy(np.stack(tgts)), clique=clique,
                valid=clique.sum(-1) > 1, scale=scale,
                prior=prior.contiguous(), has_prior=prior_kind is not None,
                config=dataclasses.replace(SolverConfig(), **opts))


def cote_tie_case():
    """COTE on given points whose values tie: four rows of 16 points, the
    per-axis values (dst - src) all equal on the first row, exactly -0.0
    and +0.0 (with a noise bound of 0, so that entries and exits meet at
    +-0) on the second, a mix on the third, and the last row masked off
    but for one point. Returns (src, dst, mask) on the CPU."""
    n = 16
    x = np.zeros((4, n, 3), np.float32)
    x[0] = 0.25
    x[1, ::2] = -0.0
    x[1, 1::2] = 0.0
    x[2] = np.where(np.arange(n)[:, None] % 3 == 0, -0.0, 0.5)
    x[3] = np.linspace(-1, 1, n * 3, dtype=np.float32).reshape(n, 3)
    src = np.random.default_rng(3).uniform(-5, 5, (4, n, 3)).astype(
        np.float32)
    src[1] = 0.0                      # dst - src is then x itself
    mask = np.ones((4, n), bool)
    mask[2, -3:] = False
    mask[3, 1:] = False
    return (torch.from_numpy(src), torch.from_numpy(src + x),
            torch.from_numpy(mask))


# ------------------------------------------------- the route before them --

def former_chain_order(inlier_mask):
    n = inlier_mask.shape[-1]
    iota = torch.arange(n, device=inlier_mask.device)
    order = torch.sort(torch.where(inlier_mask, iota, n + iota), dim=-1,
                       stable=True).indices
    m = inlier_mask.sum(-1)
    nxt = torch.where(iota + 1 < m[..., None], iota + 1, 0)
    return order, order.gather(-1, nxt), iota < m[..., None], m


def former_solve_from_inliers(src, tgt, clique_mask, valid, scale, config,
                              prior_ryrx, has_prior):
    """solver/quatro.py's ``_solve_from_inliers`` before the polish's
    kernels, operation for operation (its GNC the yaw / SO(3) loop of
    solver/rotation.py, its COTE solver/translation.py's plain one)."""
    from quatro_tpu_torch.solver import rotation as rot_mod
    from quatro_tpu_torch.solver import translation as trans_mod
    from quatro_tpu_torch.types import RegistrationSolution

    dtype, dev = src.dtype, src.device
    n = src.shape[-2]
    rows = clique_mask.shape[:-1]
    lead = (src.shape[0],) + (1,) * (clique_mask.dim() - 2)

    def per_row(x):
        return x.reshape(*lead, n, 3).expand(*rows, n, 3)

    src_r, tgt_r = per_row(src), per_row(tgt)
    if prior_ryrx.dim() == 3:
        prior_ryrx = prior_ryrx.reshape(*lead, 3, 3)
    order, leaf, chain_mask, m = former_chain_order(clique_mask)
    chainf = chain_mask.to(dtype)[..., None]
    src_tims = (gather_rows(src_r, leaf) - gather_rows(src_r, order)) * chainf
    dst_tims = ((gather_rows(tgt_r, leaf) - gather_rows(tgt_r, order))
                * chainf / scale[..., None, None])
    if has_prior:
        src_tims = rotate_points(src_tims, prior_ryrx)
    rot_noise_bound = torch.full_like(
        scale, config.noise_bound * config.rotation_noise_bound_scale) / scale
    gnc_args = (rot_noise_bound, config.rotation_gnc_factor,
                config.rotation_max_iterations,
                config.rotation_cost_threshold)
    algo = config.rotation_estimation_algorithm
    if config.reg_name == "Quatro":
        theta, weights, inl, iters, cost = rot_mod._loop(algo)(
            src_tims[..., :2], dst_tims[..., :2], chain_mask, *gnc_args,
            *rot_mod._YAW)
        gnc = rot_mod.GncResult(rot_mod.rot2d(theta), weights, inl, iters,
                                cost)
        rotation = torch.eye(3, dtype=dtype, device=dev).repeat(*rows, 1, 1)
        rotation[..., :2, :2] = gnc.rotation
    else:
        gnc = rot_mod.gnc_rotation_3d(src_tims, dst_tims, chain_mask,
                                      *gnc_args, algorithm=algo)
        rotation = gnc.rotation
    rotation = rotate_points(rotation, prior_ryrx.transpose(-1, -2))

    iota = torch.arange(n, device=dev)
    prev = torch.where(iota == 0, torch.clamp(m - 1, min=0)[..., None],
                       iota - 1)
    rot_inliers = (gnc.inlier_mask & gnc.inlier_mask.gather(-1, prev)
                   & chain_mask)
    num_rot_inliers = rot_inliers.sum(-1).to(torch.int32)
    if config.using_rot_inliers_when_estimating_cote:
        sel_mask = torch.where((num_rot_inliers > 0)[..., None], rot_inliers,
                               chain_mask)
    else:
        sel_mask = chain_mask
    pos_order = torch.sort(torch.where(sel_mask, iota, n + iota), dim=-1,
                           stable=True).indices
    cote_mask = iota < sel_mask.sum(-1, keepdim=True)
    sel_idx = order.gather(-1, pos_order)
    cote = trans_mod.solve_translation_plain(
        rotate_points(scale[..., None, None] * gather_rows(src_r, sel_idx),
                      rotation), gather_rows(tgt_r, sel_idx),
        cote_mask, config.noise_bound * config.cote_noise_bound_coeff,
        config.cbar2, use_median=(config.cote_mode == "median"))
    final_mask = torch.zeros_like(clique_mask).scatter(
        -1, sel_idx, cote.inlier_mask & cote_mask)
    eye = torch.eye(3, dtype=dtype, device=dev)
    return RegistrationSolution(
        valid=valid, scale=scale,
        rotation=torch.where(valid[..., None, None], rotation, eye),
        translation=torch.where(valid[..., None], cote.translation, 0.0),
        max_clique_mask=clique_mask,
        final_inlier_mask=final_mask & valid[..., None],
        num_rotation_inliers=num_rot_inliers,
        gnc_iterations=gnc.iterations, gnc_cost=gnc.cost)


def solve_case(case, device="cpu"):
    """solver/quatro.py's ``_solve_from_inliers`` on a case's tensors."""
    from quatro_tpu_torch.solver.quatro import _solve_from_inliers
    t = {k: (v.to(device) if torch.is_tensor(v) else v)
         for k, v in case.items()}
    return _solve_from_inliers(t["src"], t["tgt"], t["clique"], t["valid"],
                               t["scale"], t["config"], t["prior"],
                               t["has_prior"])


def solution_fields(sol):
    return [getattr(sol, f.name) for f in dataclasses.fields(sol)]


def same_bits(a, b):
    """Equal dtypes, shapes and bits (f32 through their int32 views, so
    -0.0 counts), NaN at the same places whatever its payload."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a).view(torch.int32),
        torch.where(nan, 0.0, b).view(torch.int32))


@contextlib.contextmanager
def plain_polish_route():
    """The polish through the plain versions of its kernels whatever the
    tensors' device (ops/polish.py's ``*_plain``, the yaw GNC
    solver/rotation.gnc_rotation_2d_plain, its ``while_chunks`` loop): the
    route the kernels replace, for holding them against it on the card."""
    from quatro_tpu_torch.ops import polish
    from quatro_tpu_torch.solver import quatro, rotation, translation

    swaps = [(quatro, "polish_chain", polish.polish_chain_plain),
             (quatro, "polish_cote", polish.polish_cote_plain),
             (rotation, "gnc_yaw", rotation.gnc_rotation_2d_plain),
             (translation, "cote_translation",
              polish.cote_translation_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
