"""The port's configuration mirror equals the JAX package's, field by field
and default by default, and carries a configuration across both ways."""

import dataclasses

import pytest
import torch

import quatro_tpu.config as jcfg
import quatro_tpu_torch.config as tcfg


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _assert_same(j, t, path="cfg"):
    assert type(j).__name__ == type(t).__name__, path
    jf = [f.name for f in dataclasses.fields(j)]
    tf = [f.name for f in dataclasses.fields(t)]
    assert jf == tf, f"{path}: fields {jf} != {tf}"
    for name in jf:
        jv, tv = getattr(j, name), getattr(t, name)
        if dataclasses.is_dataclass(jv):
            _assert_same(jv, tv, f"{path}.{name}")
        else:
            assert jv == tv and type(jv) is type(tv), \
                f"{path}.{name}: {jv!r} != {tv!r}"


CONFIGS = {
    "default": lambda m: m.PipelineConfig(),
    "recommended": lambda m: m.PipelineConfig.recommended(),
    "vlp16": lambda m: m.PipelineConfig.for_lidar("VLP-16"),
    "os1_64_overrides": lambda m: m.PipelineConfig.for_lidar(
        "Ouster-OS1-64", max_voxels=2048),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fields_and_defaults_match(name):
    _assert_same(CONFIGS[name](jcfg), CONFIGS[name](tcfg))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dict_round_trip(name):
    j = CONFIGS[name](jcfg)
    t = tcfg.config_from_dict(dataclasses.asdict(j))
    _assert_same(j, t)
    assert tcfg.config_from_dict(tcfg.config_to_dict(t)) == t
    assert tcfg.config_to_dict(t) == dataclasses.asdict(j)


def test_lidar_presets_and_checks_match():
    for name in ("Velodyne-64-HDE", "VLP-16", "HDL-32E", "Ouster-OS1-16",
                 "Ouster-OS1-64"):
        _assert_same(jcfg.LidarConfig.preset(name),
                     tcfg.LidarConfig.preset(name))
        _assert_same(jcfg.FPFHConfig.for_lidar(jcfg.LidarConfig.preset(name)),
                     tcfg.FPFHConfig.for_lidar(tcfg.LidarConfig.preset(name)))
    bad = [lambda m: m.SolverConfig(noise_bound=0.0),
           lambda m: m.SolverConfig(inlier_selection_mode="bogus"),
           lambda m: m.FPFHConfig(normal_radius=2.0, fpfh_radius=1.0),
           lambda m: m.PipelineConfig(ground_segmentation_mode="x"),
           lambda m: m.IcpConfig(iterations=0)]
    for make in bad:
        with pytest.raises(ValueError):
            make(jcfg)
        with pytest.raises(ValueError):
            make(tcfg)
    with pytest.raises(ValueError):
        tcfg.config_from_dict({"no_such_field": 1})
