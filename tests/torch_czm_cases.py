"""The Patchwork configurations and the batch of special points that the
CZM kernels (quatro_tpu_torch/ops/czm.py) are held on: the kernels' models
on the CPU (tests/test_torch_czm.py), the kernels on the card
(tests/test_torch_kernels_gpu.py) and chip_smoke.py's Patchwork cases."""

import torch

# dataclasses.replace arguments of a PatchworkConfig
CZM_CONFIGS = {
    "default": {},
    "sensor_height_0": dict(sensor_height=0.0),
    "global_elevation_num_iter_1": dict(using_global_elevation=True,
                                        num_iter=1),
    "three_zones": dict(num_zones=3, num_sectors_each_zone=(12, 24, 40),
                        num_rings_each_zone=(2, 3, 4),
                        min_ranges_each_zone=(2.7, 10.0, 30.0), max_r=70.0),
}


def czm_specials(points, mask, cfg):
    """Copies of two clouds (2, N, 3) and (2, N), N >= 18, with an empty
    third cloud appended, for the Patchwork configuration ``cfg``: both
    lifted 2 m where the sensor height is 0 (whose cut then keeps z >= 0);
    NaN and inf coordinates in valid and masked points; in each cloud a
    point on the CZM's inner edge (outside) and one on its outer edge
    (inside); in the first a point at the cut's height, in the second a
    kept point at +inf height (its z range, and so its seed stage's bins,
    unbounded). Returns (3, N, 3) f32 and (3, N) bool, contiguous."""
    pts, mask = points.clone(), mask.clone()
    if cfg.sensor_height == 0.0:
        pts[..., 2] += 2.0
    pts[0, 3, 1] = float("nan")
    pts[1, 5] = float("nan")
    mask[1, 5] = False
    pts[0, 7, 0] = float("inf")
    pts[1, 9, 2] = -float("inf")
    pts[0, 11] = torch.tensor([float("inf"), float("inf"), 1.0])
    pts[:, 13] = torch.tensor([cfg.min_r, 0.0, 0.5])
    pts[:, 15] = torch.tensor([0.0, cfg.max_r, 0.5])
    pts[0, 17] = torch.tensor([-4.0, -0.0, -1.8 * cfg.sensor_height])
    pts[1, 17] = torch.tensor([5.0, 5.0, float("inf")])
    mask[:, 13:18] = True
    return (torch.cat([pts, torch.zeros_like(pts[:1])]).contiguous(),
            torch.cat([mask, torch.zeros_like(mask[:1])]).contiguous())
