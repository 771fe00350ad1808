"""The voxel grid's three plain pieces (ops/voxel.py's voxel_keys_plain,
voxel_select_plain and voxel_centroids_plain, the plain versions of
csrc/voxel.cu's kernels) against the JAX package's ``voxel_downsample``
and against the grid's former torch route, on the CPU, on
tests/torch_voxel_cases.py's clouds. On the card each kernel is held bit
for bit against its plain version by tests/test_torch_kernels_gpu.py.

Tolerances, and what was measured on these inputs:
- masks and slot order: equal to the JAX package's, exactly;
- centroids: within 1e-5 m of the JAX package's, the bound
  tests/test_torch_frontend_prep.py states (the port rounds minb + (k +
  s / cnt) * leaf at each operation, where XLA fuses it);
- against the former route (``former_voxel_downsample`` below, the grid's
  torch code before its kernels): every output and every intermediate
  the pieces hand on, bit for bit;
- ``prefix_at`` against ``prefix_sum``: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quatro_tpu.ops.voxel import voxel_downsample as jax_voxel

from quatro_tpu_torch.ops import voxel as tv
from quatro_tpu_torch.ops.launch import LAUNCHES
from quatro_tpu_torch.utils.scan import prefix_at, prefix_sum

from torch_voxel_cases import CASES, VOXEL, voxel_case

ATOL = 1e-5
SINGLE = [c for c in CASES if c != "batch3"]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------- the former torch route --

def _former_part1by2(v):
    v = v & 0x3FF
    v = (v | (v << 16)) & 0xFF0000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _former_compact1by2(v):
    v = v & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0xFF0000FF
    v = (v | (v >> 16)) & 0x3FF
    return v


def former_voxel_downsample(points, mask, voxel_size, capacity,
                            active_cap=None):
    """The grid's torch route before its kernels, as it stood: (out,
    out_mask, {intermediate: tensor})."""
    n = points.shape[-2]
    sentinel = (1 << 31) - 1
    dtype = points.dtype

    def f32(v):
        return torch.full((), v, dtype=dtype)

    inv = f32(1.0 / voxel_size)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    minb = torch.where(mask[..., None], points,
                       f32(float("inf"))).amin(dim=-2)
    mx, my, mz = minb[..., 0:1], minb[..., 1:2], minb[..., 2:3]
    cx = torch.floor((x - mx) * inv)
    cy = torch.floor((y - my) * inv)
    cz = torch.floor((z - mz) * inv)
    in_grid = (mask & (cx >= 0) & (cx < 1024) & (cy >= 0) & (cy < 1024)
               & (cz >= 0) & (cz < 1024))
    zero = f32(0.0)
    cx = torch.where(in_grid, cx, zero)
    cy = torch.where(in_grid, cy, zero)
    cz = torch.where(in_grid, cz, zero)
    key = (_former_part1by2(cx.to(torch.int64))
           + (_former_part1by2(cy.to(torch.int64)) << 1)
           + (_former_part1by2(cz.to(torch.int64)) << 2))
    key = torch.where(in_grid, key, sentinel)
    fx = torch.where(in_grid, (x - mx) * inv - cx, zero)
    fy = torch.where(in_grid, (y - my) * inv - cy, zero)
    fz = torch.where(in_grid, (z - mz) * inv - cz, zero)
    fmax = float((1 << 15) - 1)
    qx = torch.clamp(fx * 32768.0, 0.0, fmax).to(torch.int64)
    qy = torch.clamp(fy * 32768.0, 0.0, fmax).to(torch.int64)
    qz = torch.clamp(fz * 32768.0, 0.0, fmax).to(torch.int64)
    pf_xy = (qx << 15) + qy
    mid = dict(minb=minb, key=key, pf_xy=pf_xy, qz=qz)

    key_s, order = torch.sort(key, dim=-1, stable=True)
    pfxy_s = pf_xy.gather(-1, order)
    qz_s = qz.gather(-1, order)
    if active_cap is not None and active_cap < n:
        key_s = key_s[..., :active_cap]
        pfxy_s = pfxy_s[..., :active_cap]
        qz_s = qz_s[..., :active_cap]
        n = active_cap
    valid_b = key_s != sentinel
    inv_fscale = f32(1.0 / 32768.0)
    vf = valid_b.to(dtype)
    fx_s = ((pfxy_s >> 15).to(dtype) + 0.5) * inv_fscale * vf
    fy_s = ((pfxy_s & 32767).to(dtype) + 0.5) * inv_fscale * vf
    fz_s = (qz_s.to(dtype) + 0.5) * inv_fscale * vf

    pos = torch.arange(n)
    true1 = torch.ones(key_s.shape[:-1] + (1,), dtype=torch.bool)
    is_new = torch.cat([true1, key_s[..., 1:] != key_s[..., :-1]],
                       -1) & valid_b
    start_pos = torch.where(is_new, pos, n)
    run_end = torch.where(torch.cat([is_new[..., 1:], true1], -1), pos + 1, n)
    next_start = torch.flip(
        torch.cummin(torch.flip(run_end, [-1]), -1).values, [-1])
    run_len = torch.where(is_new, next_start - start_pos, 0)
    k = min(capacity, n)
    cmax = (1 << 14) - 1
    rank_key = torch.where(
        is_new, ((cmax - torch.clamp(run_len, max=cmax)) << 17) + pos,
        sentinel)
    rank_s = torch.sort(rank_key, dim=-1).values[..., :k]
    sel_pos = torch.where(rank_s != sentinel, rank_s & ((1 << 17) - 1), n)
    sel_pos = torch.sort(sel_pos, dim=-1).values
    got = sel_pos < n
    starts_top = torch.where(got, sel_pos, 0)
    counts_top = torch.where(got, run_len.gather(-1, starts_top), 0)
    mid.update(starts_top=starts_top, counts_top=counts_top)

    cs3 = prefix_sum(torch.stack([fx_s, fy_s, fz_s], -2))

    def at(idx):
        return cs3.gather(-1, idx[..., None, :].expand(
            *idx.shape[:-1], 3, idx.shape[-1]))

    ends = starts_top + counts_top
    hi3 = at(torch.clamp(ends - 1, 0, n - 1))
    lo3 = torch.where(starts_top[..., None, :] > 0,
                      at(torch.clamp(starts_top - 1, min=0)), zero)
    sums3 = hi3 - lo3
    out_mask = counts_top > 0
    cnt = torch.clamp(counts_top, min=1).to(dtype)
    kk = key_s.gather(-1, torch.clamp(starts_top, max=n - 1))
    mid["key_top"] = kk
    kx = _former_compact1by2(kk).to(dtype)
    ky = _former_compact1by2(kk >> 1).to(dtype)
    kz = _former_compact1by2(kk >> 2).to(dtype)
    leaf = f32(voxel_size)
    ox = mx + (kx + sums3[..., 0, :] / cnt) * leaf
    oy = my + (ky + sums3[..., 1, :] / cnt) * leaf
    oz = mz + (kz + sums3[..., 2, :] / cnt) * leaf
    out = torch.stack([ox, oy, oz], dim=-1)
    out = torch.where(out_mask[..., None], out, zero)
    if k < capacity:
        pad = capacity - k
        out = torch.nn.functional.pad(out, (0, 0, 0, pad))
        out_mask = torch.nn.functional.pad(out_mask, (0, pad))
    return out, out_mask, mid


# ------------------------------------------------------------- helpers --

def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_bits(got, ref, what):
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert torch.equal(_bits(got), _bits(ref)), what


def _torch_case(name):
    pts, mask, cap, act = voxel_case(name)
    return torch.from_numpy(pts), torch.from_numpy(mask), cap, act


def _pieces(pts, mask, cap, act):
    """The three plain pieces composed as ``voxel_downsample`` composes
    them: (out, out_mask, {intermediate: tensor})."""
    minb, key, payload = tv.voxel_keys_plain(pts, mask, VOXEL)
    key_s, order = torch.sort(key, dim=-1, stable=True)
    n = key.shape[-1] if act is None or act >= key.shape[-1] else act
    starts, counts, key_top = tv.voxel_select_plain(key_s, n, cap)
    out, out_mask = tv.voxel_centroids_plain(
        key_s, order, payload, minb, starts, counts, key_top, n, VOXEL)
    return out, out_mask, dict(minb=minb, key=key, payload=payload,
                               starts_top=starts, counts_top=counts,
                               key_top=key_top)


def _jax_rows(pts, mask, cap, act):
    """The JAX package's voxel_downsample on each cloud: (out, mask)
    numpy, stacked."""
    fn = jax.jit(lambda p, m: jax_voxel(p, m, VOXEL, cap, active_cap=act))
    outs = [fn(jnp.asarray(p), jnp.asarray(m))
            for p, m in zip(pts.numpy(), mask.numpy())]
    return (np.stack([np.asarray(o[0]) for o in outs]),
            np.stack([np.asarray(o[1]) for o in outs]))


# --------------------------------------------------------------- tests --

@pytest.mark.parametrize("case", CASES)
def test_voxel_pieces_match_jax(case):
    """The three plain pieces composed: masks and slot order exactly the
    JAX package's, centroids within ATOL."""
    pts, mask, cap, act = _torch_case(case)
    out, out_mask, _ = _pieces(pts, mask, cap, act)
    jp, jm = _jax_rows(pts, mask, cap, act)
    np.testing.assert_array_equal(out_mask.numpy(), jm)
    np.testing.assert_allclose(out.numpy(), jp, rtol=0, atol=ATOL)
    if case == "all_masked":
        assert not jm.any()
    if case in ("ties", "dense_voxel", "no_active_cap"):
        assert jm.all()                          # the capacity binds


@pytest.mark.parametrize("case", CASES)
def test_voxel_pieces_equal_the_former_route(case):
    """Every output and the intermediates each piece hands on (corner,
    keys, payload, chosen starts, counts and keys) bit for bit the former
    torch route's."""
    pts, mask, cap, act = _torch_case(case)
    out, out_mask, mid = _pieces(pts, mask, cap, act)
    ref_out, ref_mask, ref = former_voxel_downsample(pts, mask, VOXEL, cap,
                                                     act)
    _assert_bits(out, ref_out, "centroids")
    _assert_bits(out_mask, ref_mask, "mask")
    _assert_bits(mid["minb"], ref["minb"], "corner")
    _assert_bits(mid["key"].long(), ref["key"], "keys")
    _assert_bits(mid["payload"][..., 0].long(), ref["pf_xy"], "payload xy")
    _assert_bits(mid["payload"][..., 1].long(), ref["qz"], "payload z")
    k = ref["starts_top"].shape[-1]
    for name in ("starts_top", "counts_top", "key_top"):
        _assert_bits(mid[name][..., :k].long(), ref[name], name)
        assert not mid["counts_top"][..., k:].any()


@pytest.mark.parametrize("case", CASES)
def test_voxel_downsample_equals_the_former_route(case):
    """The public function: bit for bit the former route, and its
    wrappers took their plain versions (no launch counted on the CPU)."""
    pts, mask, cap, act = _torch_case(case)
    before = dict(LAUNCHES)
    out, out_mask = tv.voxel_downsample(pts, mask, VOXEL, cap,
                                        active_cap=act)
    assert LAUNCHES == before
    ref_out, ref_mask, _ = former_voxel_downsample(pts, mask, VOXEL, cap,
                                                   act)
    _assert_bits(out, ref_out, "centroids")
    _assert_bits(out_mask, ref_mask, "mask")


def test_voxel_batch_rows_are_their_own_calls():
    """A batch of three clouds (a scan, the ties lattice, an all-masked
    cloud) in one call: each row the cloud's own call, bit for bit, and
    the unbatched (N, 3) call the row of a batch of one."""
    pts, mask, cap, act = _torch_case("batch3")
    out, out_mask = tv.voxel_downsample(pts, mask, VOXEL, cap,
                                        active_cap=act)
    for c in range(pts.shape[0]):
        one = tv.voxel_downsample(pts[c], mask[c], VOXEL, cap,
                                  active_cap=act)
        _assert_bits(out[c], one[0], f"cloud {c} centroids")
        _assert_bits(out_mask[c], one[1], f"cloud {c} mask")
    assert not out_mask[2].any() and not out[2].any()


@pytest.mark.parametrize("n", [1, 5, 16, 17, 250, 4097, 32768, 32771,
                               131072])
def test_prefix_at_matches_prefix_sum(n):
    """The boundary route of the centroids' prefix against ``prefix_sum``
    (XLA:CPU's blocked order), bit for bit, at lengths that are not a
    multiple of 16 and at the recursion depths of n = 32768 (4 levels) and
    n = 131072 (5)."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.uniform(0.0, 1.0, (2, 3, n)).astype(np.float32))
    idx = torch.from_numpy(np.concatenate(
        [[0, n - 1, min(15, n - 1), min(16, n - 1)],
         rng.integers(0, n, 60)]).astype(np.int64))
    idx = idx.expand(2, 3, -1).contiguous()
    _assert_bits(prefix_at(x, idx), prefix_sum(x).gather(-1, idx),
                 f"prefix at n = {n}")


def test_voxel_wrappers_refuse_bad_inputs():
    pts = torch.zeros(2, 64, 3)
    mask = torch.ones(2, 64, dtype=torch.bool)
    with pytest.raises(ValueError):
        tv.voxel_keys(pts[0], mask[0], VOXEL)          # not (C, N, 3)
    with pytest.raises(ValueError):
        tv.voxel_keys(pts, mask[:, :32], VOXEL)
    key = torch.zeros(2, 64, dtype=torch.int32)
    with pytest.raises(ValueError):
        tv.voxel_select(key, 65, 16)                    # prefix past N
    with pytest.raises(ValueError):
        tv.voxel_select(key, 64, 0)
    with pytest.raises(TypeError):
        tv.voxel_select(key.long(), 64, 16)
    with pytest.raises(ValueError):
        tv.voxel_downsample(torch.zeros((1 << 17) + 1, 3),
                            torch.zeros((1 << 17) + 1, dtype=torch.bool),
                            VOXEL, 64)
