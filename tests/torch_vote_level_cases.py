"""The inputs the vote, the ground leveling and the moment normals are held
on: by tests/test_torch_vote_level_kernels.py (the plain pieces against
the JAX package and the route before the kernels, on the CPU), by the
``gpu`` tests (each kernel against its plain version on the card) and by
chip_smoke.py. Everything is made from a seed with numpy and returned as
CPU tensors; no JAX here.

Vote cases (``vote_case``): batches (B, N, 3) of correspondences with
masks, the consistency graph (B, N, N), scales and the vote's settings:

- ``aliased``: tests/test_vote.py's planted aliasing conflict (N = 256);
- ``batch3_junk``: three pairs, the third junk (uniform clouds);
- ``no_valid``: a pair with every correspondence masked beside a normal
  one;
- ``ties64``: a graph whose degrees tie across the 64th anchor (a clique
  of 90 under a random permutation, so the anchors are the lowest of
  tied indices);
- ``clamp``: translations past the 10-bit grid on both sides, and at its
  top corner, where the second grid's key is the sort's sentinel;
- ``n500`` (2N not a power of two, N % 16 != 0) and ``n1024``.

Ground cases (``ground_clouds``): named clouds (N, 3) with ground masks:
a tilted plane (N = 3000, 5001 and 700: the tree's padding), no ground
point, fewer than ``min_points``, a wall (the tilt gate) and a bowl (the
flatness gate). ``ground_pairs`` gives (src, tgt) batches of them.

Normals cases (``normals_case``): B3's moments of two clouds at the
normal radius, with counts below 3 and counts of 0 planted.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from quatro_tpu_torch.config import GroundAlignmentConfig
from quatro_tpu_torch.io.synthetic import make_correspondences
from quatro_tpu_torch.ops import frontend as tf
from quatro_tpu_torch.solver.scale import tim_consistency_graph

VOTE_CASES = ("aliased", "batch3_junk", "no_valid", "ties64", "clamp",
              "n500", "n1024")
GROUND_CONFIG = GroundAlignmentConfig(enabled=True)
GROUND_CLOUDS = ("tilted", "tilted_b", "npow2", "small", "no_ground",
                 "few_points", "wall", "bowl")
NORMAL_RADIUS = 0.75


def _yaw(deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def aliased_pair(seed=0, n_true=14, n_alias=40, n_noise=200, yaw_deg=35.0,
                 t_true=(2.0, -1.0, 0.1), period=(4.0, 0.0, 0.0),
                 noise=0.02, n_pad=256):
    """tests/test_vote.py's planted aliasing conflict: n_true inliers follow
    (R, t_true), n_alias follow (R, t_true + period), n_noise are junk;
    numpy (src, tgt, mask) padded to n_pad."""
    rng = np.random.default_rng(seed)
    rot = _yaw(yaw_deg)
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
    mask = np.zeros(n_pad, bool)
    mask[:n_pad - pad] = True
    return (np.pad(src, ((0, pad), (0, 0))), np.pad(tgt, ((0, pad), (0, 0))),
            mask)


def _graph(src, tgt, mask, noise=0.1):
    return tim_consistency_graph(torch.from_numpy(src), torch.from_numpy(tgt),
                                 torch.from_numpy(mask), noise, 1.0)


def _stack(pairs):
    return tuple(torch.from_numpy(np.stack(x)) for x in zip(*pairs))


def vote_case(name):
    """dict(src, tgt, mask (B, N), adj (B, N, N), scale (B,), bin_m,
    num_hyps) of a named vote case, CPU tensors."""
    bin_m, num_hyps = 0.75, 3
    if name == "aliased":
        pairs = [aliased_pair()]
    elif name == "batch3_junk":
        rng = np.random.default_rng(3)
        junk = rng.uniform(-30, 30, (2, 256, 3)).astype(np.float32)
        pairs = [aliased_pair(0), aliased_pair(1, yaw_deg=-70.0),
                 (junk[0], junk[1], np.ones(256, bool))]
    elif name == "no_valid":
        s, t, _ = aliased_pair(2)
        pairs = [aliased_pair(2), (s, t, np.zeros(256, bool))]
    elif name == "n500" or name == "n1024":
        n = 500 if name == "n500" else 1024
        src, tgt, _, _ = make_correspondences(
            seed=5, n_inliers=n // 5, n_outliers=n - n // 5, yaw_deg=63.0,
            translation=(4.0, -2.5, 0.4))
        mask = np.ones(n, bool)
        mask[-7:] = False
        pairs = [(src.astype(np.float32), tgt.astype(np.float32), mask)]
    elif name == "clamp":
        rng = np.random.default_rng(7)
        n = 192
        src = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        off = np.zeros((n, 3), np.float32)
        off[:64] = 40.0                       # past the grid's top corner
        off[64:128] = -40.0                   # past its bottom
        off[128:160, 0] = 40.0                # one axis only
        tgt = (src + off + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
        pairs = [(src, tgt, np.ones(n, bool))]
        bin_m = 0.05
    elif name == "ties64":
        rng = np.random.default_rng(8)
        n = 160
        src, tgt, mask = aliased_pair(4, n_pad=n, n_noise=100)
        perm = rng.permutation(n)
        adj = np.zeros((n, n), bool)
        members = perm[:90]                   # a clique of 90: degree 89
        adj[np.ix_(members, members)] = True
        extra = perm[90:120]                  # degree 20 each
        for i in range(30):
            j = perm[90 + (i + 1) % 30]
            adj[extra[i], j] = adj[j, extra[i]] = True
        np.fill_diagonal(adj, False)
        mask[:] = True
        mask[perm[150:]] = False              # a few masked rows
        case = _stack([(src, tgt, mask)])
        return dict(src=case[0], tgt=case[1], mask=case[2],
                    adj=torch.from_numpy(adj)[None],
                    scale=torch.ones(1), bin_m=bin_m, num_hyps=num_hyps)
    else:
        raise KeyError(name)
    src, tgt, mask = _stack(pairs)
    adj = torch.stack([_graph(s.numpy(), t.numpy(), m.numpy())
                       for s, t, m in zip(src, tgt, mask)])
    scale = torch.ones(src.shape[0])
    return dict(src=src.contiguous(), tgt=tgt.contiguous(),
                mask=mask.contiguous(), adj=adj.contiguous(), scale=scale,
                bin_m=bin_m, num_hyps=num_hyps)


def _plane(rng, n, tilt=(0.07, -0.05), z0=-1.7, noise=0.02):
    xy = rng.uniform(-20, 20, (n, 2))
    z = z0 + tilt[0] * xy[:, 0] + tilt[1] * xy[:, 1] + rng.normal(0, noise, n)
    return np.concatenate([xy, z[:, None]], 1).astype(np.float32)


def ground_clouds():
    """{name: (points (N, 3), ground mask (N,))} numpy; the masks mark the
    ground points (the rest of the cloud, unmasked, is clutter)."""
    rng = np.random.default_rng(21)
    out = {}
    for name, n, tilt in (("tilted", 3000, (0.07, -0.05)),
                          ("tilted_b", 3000, (-0.04, 0.06)),
                          ("npow2", 5001, (0.02, 0.03)),
                          ("small", 700, (0.0, 0.0))):
        pts = _plane(rng, n, tilt)
        mask = np.ones(n, bool)
        mask[rng.random(n) < 0.2] = False     # clutter
        pts[~mask, 2] += rng.uniform(0.5, 3.0, (~mask).sum())
        out[name] = (pts, mask)
    pts = _plane(rng, 3000)
    out["no_ground"] = (pts, np.zeros(3000, bool))
    few = np.zeros(3000, bool)
    few[:50] = True                           # under min_points (256)
    out["few_points"] = (pts, few)
    u = rng.uniform(-10, 10, (3000, 2))
    out["wall"] = (np.stack([np.full(3000, 5.0), u[:, 0], u[:, 1]], 1
                            ).astype(np.float32), np.ones(3000, bool))
    out["bowl"] = (np.stack([u[:, 0], u[:, 1], 0.05 * (u ** 2).sum(1)], 1
                            ).astype(np.float32), np.ones(3000, bool))
    return out


def ground_pairs():
    """{name: (src (B, N, 3), src mask, tgt (B, N, 3), tgt mask)} CPU
    tensors: pairs that level, and pairs where one side fails a gate."""
    c = ground_clouds()

    def batch(names):
        return (torch.from_numpy(np.stack([c[k][0] for k in names])),
                torch.from_numpy(np.stack([c[k][1] for k in names])))

    out = {}
    for name, src, tgt in (
            ("level", ["tilted"], ["tilted_b"]),
            ("gates", ["tilted", "no_ground", "wall", "bowl", "few_points"],
             ["tilted_b", "tilted", "tilted_b", "tilted", "tilted"])):
        out[name] = (*batch(src), *batch(tgt))
    for name in ("npow2", "small"):
        p, m = batch([name])
        out[name] = (p, m, p.clone(), m.clone())
    return out


def normals_case(seed=0, v=512):
    """(points (2, V, 3), mask (2, V), moments (2, V, 10)) CPU tensors:
    B3's plain moments of two random clouds at NORMAL_RADIUS, with counts
    of 2, 1 and 0 planted (count 0: every moment 0)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, (2, v, 3)).astype(np.float32)
    pts[:, :, 2] *= 0.1                        # flattish patches
    mask = np.ones((2, v), bool)
    mask[0, -40:] = False
    mask[1, ::17] = False
    p = torch.from_numpy(pts)
    mom = tf.moment_sums_plain(p, torch.from_numpy(mask).float(),
                               NORMAL_RADIUS).clone()
    mom[0, 5, 0] = 2.0
    mom[0, 6, 0] = 1.0
    mom[1, 7] = 0.0
    mom[1, 8, 0] = 0.0
    return p, torch.from_numpy(mask), mom


@contextlib.contextmanager
def plain_vote_level_route():
    """The vote, the leveling and the moment normals through the plain
    versions of their kernels whatever the tensors' device (ops/vote.py's
    and ops/ground.py's ``*_plain``, ops/normals.normals_from_moments): the
    route the kernels replace, for holding them against it on the card."""
    from quatro_tpu_torch.ops import frontend, ground, normals, vote
    from quatro_tpu_torch.solver import ground as sground
    from quatro_tpu_torch.solver import vote as svote

    swaps = [(svote, "vote_entries", vote.vote_entries_plain),
             (svote, "vote_translation", vote.vote_translation_plain),
             (sground, "ground_fit", ground.ground_fit_plain),
             (frontend, "moment_normals", normals.normals_from_moments)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def big_ground_pair(n=131072, seed=31):
    """A pair of tilted planes at a raw scan's capacity (N = 131072, the
    kernel's 2^7 points a thread) with clutter, and the same one point
    short (N = 131071): {n: (src, src mask, tgt, tgt mask)} (1, N, 3)."""
    rng = np.random.default_rng(seed)
    out = {}
    for size in (n, n - 1):
        clouds = []
        for tilt in ((0.07, -0.05), (-0.04, 0.06)):
            pts = _plane(rng, size, tilt)
            mask = rng.random(size) < 0.6
            pts[~mask, 2] += rng.uniform(0.5, 3.0, (~mask).sum())
            clouds.append((torch.from_numpy(pts)[None],
                           torch.from_numpy(mask)[None]))
        out[size] = (*clouds[0], *clouds[1])
    return out
