"""The plain versions of the matcher's two kernels and of B2's pair axis
against the JAX package on the CPU: ``match_candidates_plain``
(csrc/match_candidates.cu) through ``match_features`` on every branch,
``tuple_compact_plain`` (csrc/tuple_test.cu) against the JAX package's
``tuple_test_keep`` and compaction, and ``segment_sums_plain`` with a pair
axis (csrc/segment_sums.cu) against the JAX ``segment_sums`` per pair and
under ``jax.vmap``. On the card each kernel is held bit for bit against
its plain version by tests/test_torch_kernels_gpu.py.

Tolerances, and what was measured on these inputs:
- the matcher: every slot of every output equal (the descriptors on a 1/8
  grid, as tests/test_torch_matching.py takes them, so every distance is
  exact in any summation order);
- the tuple test and the compaction: equal, exactly (integer work and the
  same f32 lengths: the plain version divides by ``tuple_scale`` on the
  CPU as XLA:CPU does);
- B2's pair axis against the JAX kernel (its bf16 three-term split on the
  MXU, run in interpret mode): within 1e-5 relative / 1e-4 absolute, as
  tests/test_torch_kernels.py holds the one-row form; against the port's
  own per-row calls bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quatro_tpu.config as jcfg
from quatro_tpu.io import synthetic as jsyn
from quatro_tpu.ops import matching as jmatch
from quatro_tpu.ops.segment_matmul import segment_sums as jax_segment_sums
from quatro_tpu.pipeline import extract_features as jax_extract

from quatro_tpu_torch.ops import match_kernels as mk
from quatro_tpu_torch.ops import matching as tmatch
from quatro_tpu_torch.ops import segment
from quatro_tpu_torch.ops.launch import LAUNCHES

from torch_match_cases import (TUPLE_CASES, neighbor_case, segment_case,
                               tuple_case)

PAIR = dict(seed=101, yaw_deg=38.0, translation=(2.5, -1.2, 0.04))
CFG = jcfg.PipelineConfig.for_lidar("VLP-16", max_voxels=2048)
CAPACITY = 512
STARVED = 40            # valid target voxels of the starving pair
SEG_RTOL, SEG_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def features():
    """Two pairs as numpy arrays (src_xyz, tgt_xyz, src_desc, tgt_desc,
    src_mask, tgt_mask), each (2, V, ...): the level_a VLP-16 pair of
    tests/test_torch_matching.py (the JAX package's front end, descriptors
    on a 1/8 grid), and the same pair with the target cut to its first
    STARVED valid voxels, which starves under crosscheck_min_matches =
    64."""
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
    starved = tm & (np.cumsum(tm) <= STARVED)
    return (np.stack([sp, sp]), np.stack([tp, tp]), np.stack([sd, sd]),
            np.stack([td, td]), np.stack([sm, sm]), np.stack([tm, starved]))


BRANCHES = {"fallback": dict(crosscheck_min_matches=64),
            "crosscheck": dict(crosscheck_min_matches=0),
            "union": dict(use_crosscheck=False)}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_match_features_branches_equal_jax(features, branch):
    """The port's matcher on both pairs in one call (the candidates'
    keys by ``match_candidates_plain``) equals the JAX package's
    ``match_features`` on each pair, slot for slot, under each branch;
    under the fallback the first pair keeps its mutual pairs and the
    second starves into the union with second neighbours."""
    kw = BRANCHES[branch]
    before = dict(LAUNCHES)
    got = tmatch.match_features(*features, capacity=CAPACITY, device="cpu",
                                **kw)
    assert LAUNCHES == before
    for b in range(2):
        ref = jmatch.match_features(*(jnp.asarray(x[b]) for x in features),
                                    capacity=CAPACITY, **kw)
        row = got.row(b)
        for name in ("mask", "src_idx", "tgt_idx", "src_xyz", "tgt_xyz"):
            np.testing.assert_array_equal(getattr(row, name).numpy(),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=f"pair {b}: {name}")
        assert int(row.mask.sum()) >= 10
    if branch == "fallback":
        sd, td, sm, tm = (torch.from_numpy(x) for x in features[2:])
        nn_ab, nn_ba = tmatch.neighbors_both_ways(sd, td, sm, tm, top2=False)
        _, mutual = mk.match_candidates(*nn_ab, *nn_ba, None, None, None,
                                        None, sm, tm, mk.CROSSCHECK, 0)
        assert int(mutual[0]) >= 64 > int(mutual[1])


def test_match_candidates_keys_and_counts():
    """The keys on seeded neighbours: each pair's branch decided by its
    own mutual count, the count of non-sentinel keys equal to ncorr, and
    the fill of empty rows applied (filled inputs give the same keys)."""
    bsz, na, nb = 3, 300, 260
    case = neighbor_case(7, bsz, na, nb, mutual=(200, 10, 0))
    t = [None if x is None else torch.from_numpy(x) for x in case]
    keys, ncorr = mk.match_candidates(*t, mk.FALLBACK, 64)
    assert keys.shape == (bsz, 2 * (na + nb)) and keys.dtype == torch.int64
    assert ncorr.dtype == torch.int32
    live = (keys >> 32) != (1 << 31) - 1
    assert torch.equal(live.sum(-1).to(torch.int32), ncorr)
    # the rich pair keeps its mutual pairs only: no slot past the first block
    assert not live[0, na:].any() and live[1:, na:].any(-1).all()
    sm, tm = t[8], t[9]
    filled = list(t)
    for k, m in ((0, sm), (2, tm), (4, sm), (6, tm)):
        filled[k], filled[k + 1] = mk._filled(t[k], t[k + 1], m)
        filled[k] = filled[k].to(torch.int32)
    again = mk.match_candidates(*filled, mk.FALLBACK, 64)
    assert torch.equal(again[0], keys) and torch.equal(again[1], ncorr)
    with pytest.raises(ValueError):
        mk.match_candidates(*t[:4], None, None, None, None, sm, tm,
                            mk.FALLBACK, 64)


def _jax_compact(keys, ncorr, src, tgt, tt, capacity, use_tuple, min_keep,
                 seed=0):
    """quatro_tpu/ops/matching.py:295-333 on one pair's sorted keys."""
    packed_tt = jnp.asarray(keys[:tt] & 0xFFFFFFFF, jnp.int32)
    ic_t = jnp.arange(tt, dtype=jnp.int32)
    ncorr_t = jnp.minimum(jnp.int32(ncorr), tt)
    cand_pos = ic_t < ncorr_t
    keep = cand_pos
    if use_tuple:
        cs3 = jnp.take(jnp.asarray(src).T, packed_tt >> 15, axis=1)
        ct3 = jnp.take(jnp.asarray(tgt).T, packed_tt & ((1 << 15) - 1),
                       axis=1)
        tuple_keep = jmatch.tuple_test_keep(
            tuple(cs3[c] for c in range(3)), tuple(ct3[c] for c in range(3)),
            cand_pos, ncorr_t, seed=seed)
        keep = jnp.where(jnp.sum(tuple_keep) >= min_keep, tuple_keep,
                         cand_pos)
    poskey = jnp.where(keep, ic_t, tt + ic_t)
    _, packed_sel = jax.lax.sort((poskey, packed_tt), num_keys=1)
    kcount = jnp.sum(keep).astype(jnp.int32)
    sel = (packed_sel[:capacity] if tt >= capacity
           else jnp.pad(packed_sel, (0, capacity - tt)))
    out_mask = jnp.arange(capacity) < jnp.minimum(kcount, capacity)
    s_idx = jnp.where(out_mask, sel >> 15, 0).astype(jnp.int32)
    t_idx = jnp.where(out_mask, sel & ((1 << 15) - 1), 0).astype(jnp.int32)
    s_xyz = jnp.where(out_mask[:, None], jnp.asarray(src)[s_idx], 0.0)
    t_xyz = jnp.where(out_mask[:, None], jnp.asarray(tgt)[t_idx], 0.0)
    return (s_idx, t_idx, out_mask, s_xyz, t_xyz), int(jnp.sum(keep))


@pytest.mark.parametrize("case", sorted(TUPLE_CASES))
def test_tuple_compact_plain_equals_jax(case):
    tt, cap, ncorr, share, use_tuple, min_keep = TUPLE_CASES[case]
    n_cand = max(tt, 2 * max(ncorr))
    keys, nc, src, tgt = tuple_case(len(case), 2, n_cand, 900, 800, ncorr,
                                    share)
    got = mk.tuple_compact(torch.from_numpy(keys), torch.from_numpy(nc),
                           torch.from_numpy(src), torch.from_numpy(tgt), tt,
                           cap, use_tuple_test=use_tuple,
                           tuple_min_keep=min_keep)
    kept = []
    for b in range(2):
        ref, k = _jax_compact(keys[b], nc[b], src[b], tgt[b], tt, cap,
                              use_tuple, min_keep)
        kept.append(k)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(r))
    if case == "collapse":
        assert kept[1] == min(ncorr[1], tt)         # all candidates kept
    if use_tuple:
        assert min(ncorr[0], tt) > kept[0] >= min_keep   # survivors only


def _kernel_design(keys, ncorr, src, tgt, tt, cap, use_tuple, min_keep,
                   scale=0.95, trials=100, seed=0):
    """csrc/tuple_test.cu's algorithm on the host: each passing triple
    (i, i + s1, i + s2) marks its three members, then the gate and a
    stable partition by prefix position (the CPU's division for a /
    scale, as the plain version on the CPU)."""
    sc = np.float32(scale)
    outs = []
    for b in range(keys.shape[0]):
        packed = (keys[b, :tt] & 0xFFFFFFFF).astype(np.int64)
        s, t = packed >> 15, packed & 0x7FFF
        live = min(int(ncorr[b]), tt)
        keep = np.zeros(tt, bool)
        if use_tuple:
            p, q = src[b][s], tgt[b][t]
            i = np.arange(live)

            def side(x, u, v):
                d = x[u] - x[v]
                return np.sqrt((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
                               + d[:, 2] * d[:, 2])

            for s1, s2 in mk.tuple_shifts(tt, trials, seed):
                f1, f2 = (i + s1) % tt, (i + s2) % tt
                ok = (f1 < live) & (f2 < live)
                for u, v in ((i, f1), (f1, f2), (f2, i)):
                    a = side(p, u, np.where(ok, v, 0))
                    c = side(q, u, np.where(ok, v, 0))
                    ok &= (a * sc < c) & (c < a / sc)
                keep[i[ok]] = keep[f1[ok]] = keep[f2[ok]] = True
        if not use_tuple or keep.sum() < min_keep:
            keep = np.arange(tt) < live
        order = np.flatnonzero(keep)[:cap]
        out = [np.zeros(cap, np.int32), np.zeros(cap, np.int32),
               np.zeros(cap, bool), np.zeros((cap, 3), np.float32),
               np.zeros((cap, 3), np.float32)]
        n = len(order)
        out[0][:n], out[1][:n], out[2][:n] = s[order], t[order], True
        out[3][:n], out[4][:n] = src[b][s[order]], tgt[b][t[order]]
        outs.append(out)
    return outs


@pytest.mark.parametrize("case", sorted(TUPLE_CASES))
def test_tuple_kernel_design_is_the_plain_version(case):
    """The kernel's marking of a passing triple's three members and its
    partition give the plain version's roll-and-sort result."""
    tt, cap, ncorr, share, use_tuple, min_keep = TUPLE_CASES[case]
    n_cand = max(tt, 2 * max(ncorr))
    keys, nc, src, tgt = tuple_case(len(case), 2, n_cand, 900, 800, ncorr,
                                    share)
    got = mk.tuple_compact_plain(
        torch.from_numpy(keys), torch.from_numpy(nc), torch.from_numpy(src),
        torch.from_numpy(tgt), tt, cap, use_tuple, 0.95, 100, 0, min_keep)
    for b, ref in enumerate(_kernel_design(keys, nc, src, tgt, tt, cap,
                                           use_tuple, min_keep)):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[b].numpy(), r)


def test_device_shifts_upload_once():
    a = mk.device_shifts(2048, 100, 0, torch.device("cpu"))
    assert a is mk.device_shifts(2048, 100, 0, torch.device("cpu"))
    assert a.dtype == torch.int32 and a.is_contiguous()
    np.testing.assert_array_equal(a.numpy(), mk.tuple_shifts(2048, 100, 0))


def test_segment_sums_pair_axis_equals_jax():
    """B2's plain version at a pair axis: each row against the JAX
    ``segment_sums`` (interpret mode) on that row, and against ``jax.vmap``
    of it over the first two rows, N a multiple of 8192, the second row's
    ids all out of range (zeros); bit for bit each row's own call of the
    port."""
    bsz, n, k, p_pad = 3, 2 * 8192, 3, 256
    ids, vals = segment_case(11, bsz, n, k, p_pad, dead=(1,))
    before = dict(LAUNCHES)
    got = segment.segment_sums(torch.from_numpy(ids), torch.from_numpy(vals),
                               p_pad)
    assert LAUNCHES == before
    assert got.shape == (bsz, p_pad, k) and got.dtype == torch.float32
    assert not got[1].any()
    vm = np.asarray(jax.vmap(lambda i, v: jax_segment_sums(
        i, v, p_pad, interpret=True))(jnp.asarray(ids[:2]),
                                      jnp.asarray(vals[:2])))
    for b in range(bsz):
        ref = np.asarray(jax_segment_sums(jnp.asarray(ids[b]),
                                          jnp.asarray(vals[b]), p_pad,
                                          interpret=True))
        np.testing.assert_allclose(got[b].numpy(), ref, rtol=SEG_RTOL,
                                   atol=SEG_ATOL)
        if b < 2:
            np.testing.assert_allclose(got[b].numpy(), vm[b], rtol=SEG_RTOL,
                                       atol=SEG_ATOL)
        one = segment.segment_sums(torch.from_numpy(ids[b]),
                                   torch.from_numpy(vals[b]), p_pad)
        assert torch.equal(got[b], one)


@pytest.mark.parametrize("n", [38, 1024, 1025, 65536])
def test_segment_sums_plain_pair_axis_is_per_row(n):
    """The plain version's pair axis at the pose graph's N, one chunk, one
    past it and the vote's N: each row bit for bit its own call."""
    ids, vals = segment_case(n, 4, n, 4, 12 if n == 38 else 256, dead=(2,))
    p_pad = 12 if n == 38 else 256
    got = segment.segment_sums_plain(torch.from_numpy(ids),
                                     torch.from_numpy(vals), p_pad,
                                     segment.SEG_CHUNK)
    for b in range(4):
        assert torch.equal(got[b], segment.segment_sums_plain(
            torch.from_numpy(ids[b]), torch.from_numpy(vals[b]), p_pad,
            segment.SEG_CHUNK))
