"""The port's user-facing entry points against the JAX package's:
config_io (its YAML parser against ``yaml.safe_load``, the loaded
configuration against the JAX loader's), the CLI (the configuration and
arguments each subcommand builds, the register command end to end with its
PLY dumps), and eval.py (the helpers, the pairs it generates, the outlier
sweep, and evaluate_loop_closures over the pair axis).

Exactly equal: the YAML documents, the configurations and arguments, the
helpers' outputs, the generated pairs and tilts, the outlier sweep's
success rates and inlier counts, and the CLI's transform against the
port's own register_scan_pair. Within tolerance: the sweep's medians
(1e-3 deg / 1e-3 m, the f32 solvers of two packages), and the batched
loop-closure rows against batch=1's errors (1e-3 deg / 1e-4 m).
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch
import yaml

import quatro_tpu.cli as jcli
import quatro_tpu.eval as jeval
import quatro_tpu.io.synthetic as jsyn
import quatro_tpu.pipeline as jpipe
from quatro_tpu.config_io import load_params_yaml as j_load_params_yaml

import quatro_tpu_torch.cli as tcli
import quatro_tpu_torch.eval as teval
from quatro_tpu_torch.config import (FPFHConfig, LidarConfig, PipelineConfig,
                                     config_to_dict)
from quatro_tpu_torch.config_io import load_params_yaml, parse_yaml
from quatro_tpu_torch.io.synthetic import make_scan_pair
from quatro_tpu_torch.pipeline import register_scan_pair
from quatro_tpu_torch.sequence import SequenceResult
from quatro_tpu_torch.types import PointBatch

# The reference's params.yaml / patchwork_params.yaml layout, with the
# values tests/test_parity_extras.py:23-52 asserts for the reference's own
# files (which are not in the repository).
PARAMS_YAML = """\
### Parameters of the global registration demo
"/stop_for_each_frame": false
Lidar_type: "Velodyne-64-HDE"   # or VLP-16, HDL-32E, ...
ground_segmentation_mode: Patchwork
neigbor_mode: 4CrossNeighbor
voxel_size: 0.3

FPFH:
  normal_radius: 0.5
  fpfh_radius: 0.75
Quatro:
  estimating_scale: false
  noise_bound: 0.3
  noise_bound_coeff: 1.0
  rotation:
    num_max_iter: 50
    gnc_factor: 1.4
    rot_cost_diff_thr: 0.00011
"""
PATCHWORK_YAML = """\
sensor_height: 1.723

save_flag: true
patchwork:
    mode: "czm"
    verbose: false  # to check the effect of each gate
    num_iter: 3
    num_lpr: 20
    num_min_pts: 80
    th_seeds: 0.4
    th_dist: 0.3
    max_r: 80.0
    min_r: 2.7 # vicinity of the vehicle
    uprightness_thr: 0.707 # 45 deg: 0.707, 60 deg: 0.866
    adaptive_seed_selection_margin: -1.1
    using_global_elevation: false
    global_elevation_threshold: -0.5
    czm:
        num_zones: 4
        num_sectors_each_zone: [16, 32 ,54, 32]
        num_rings_each_zone: [2, 4, 4, 4]
        min_ranges_each_zone: [2.7, 12.3625, 22.025, 41.35]
        elevation_thresholds:  [-1.2, -0.9984, -0.851, -0.605]
        flatness_thresholds:  [0.0001, 0.000125, 0.000185, 0.000185]
"""
PARTIAL_YAML = "voxel_size: 0.1\nQuatro:\n  noise_bound: 0.5\n"
SCALARS_YAML = """\
a: [1, -2, +3, 0, 1.5, -.5, .5, 1., 1e5, 1.0e-4, .inf, -.Inf, ~, null]
b: [yes, No, on, OFF, true, False, "quoted # not a comment", 'it''s', 09]
c: plain words here
d:
e: ''
"""
VLP = LidarConfig.preset("VLP-16")
VLP_CFG = PipelineConfig(lidar=VLP, max_voxels=2048, max_raw_points=32768,
                         fpfh=FPFHConfig.for_lidar(VLP,
                                                   max_correspondences=256))
MEDIAN_TOL = 1e-3
ROW_DEG, ROW_M = 1e-3, 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    """The JAX CLI points jax's compile cache at a directory of its own;
    these tests keep the one the test run set."""
    monkeypatch.setattr(jcli, "_enable_compile_cache", lambda: None)


def _yaml_files(tmp_path):
    p, pw = tmp_path / "params.yaml", tmp_path / "patchwork_params.yaml"
    p.write_text(PARAMS_YAML)
    pw.write_text(PATCHWORK_YAML)
    return str(p), str(pw)


# -------------------------------------------------------------- config_io --

@pytest.mark.parametrize("doc", [PARAMS_YAML, PATCHWORK_YAML, PARTIAL_YAML,
                                 SCALARS_YAML, "", "# only a comment\n",
                                 "---\nk: v\n"],
                         ids=["params", "patchwork", "partial", "scalars",
                              "empty", "comment", "marker"])
def test_yaml_parser_matches_safe_load(doc):
    assert parse_yaml(doc) == yaml.safe_load(doc)


@pytest.mark.parametrize("doc,line", [
    ("a: 1\nb: &anchor 2\n", 2),
    ("a: 1\nb: *alias\n", 2),
    ("a: |\n  multi\n  line\n", 1),
    ("a: >\n  folded\n", 1),
    ("a: a plain\n  continued scalar\n", 2),
    ('a: "open\n  quote"\n', 1),
    ("a:\n  - 1\n  - 2\n", 2),
    ("a: {b: 1}\n", 1),
    ("a: !!str 1\n", 1),
    ("a: [1,\n  2]\n", 1),
    ("a: 1\na: 2\n", 2),
    ("a:\n\tb: 1\n", 2),
    ("a: 0x1F\n", 1),
    ("a: 2001-12-14\n", 1),
], ids=["anchor", "alias", "block-scalar", "folded", "multi-line-plain",
        "multi-line-quoted", "block-list", "flow-map", "tag",
        "multi-line-flow-list", "duplicate", "tab", "hex", "date"])
def test_yaml_parser_refuses_what_it_does_not_support(doc, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        parse_yaml(doc)


def test_load_params_yaml_matches_jax(tmp_path):
    p, pw = _yaml_files(tmp_path)
    cfg = load_params_yaml(p, pw)
    assert config_to_dict(cfg) == dataclasses.asdict(j_load_params_yaml(p, pw))
    # the values tests/test_parity_extras.py:23-52 asserts
    assert cfg.lidar.name == "Velodyne-64-HDE"
    assert cfg.ground_segmentation_mode == "Patchwork"
    assert cfg.projection.neighbor_mode == "4CrossNeighbor"
    assert cfg.voxel_size == 0.3
    assert cfg.fpfh.normal_radius == 0.5 and cfg.fpfh.fpfh_radius == 0.75
    assert cfg.solver.noise_bound == 0.3
    assert cfg.solver.estimate_scaling is False
    assert cfg.solver.rotation_max_iterations == 50
    assert cfg.solver.rotation_gnc_factor == 1.4
    assert cfg.solver.rotation_cost_threshold == 0.00011
    assert cfg.patchwork.sensor_height == 1.723
    assert cfg.patchwork.num_min_pts == 80
    assert cfg.patchwork.num_sectors_each_zone == (16, 32, 54, 32)
    assert cfg.patchwork.elevation_thresholds == (-1.2, -0.9984, -0.851,
                                                  -0.605)
    assert cfg.patchwork.using_global_elevation is False
    partial = tmp_path / "p.yaml"
    partial.write_text(PARTIAL_YAML)
    cfg = load_params_yaml(str(partial))
    assert config_to_dict(cfg) == dataclasses.asdict(
        j_load_params_yaml(str(partial)))
    assert cfg.voxel_size == 0.1 and cfg.solver.noise_bound == 0.5
    assert cfg.fpfh.fpfh_radius == 0.75


# -------------------------------------------------------------------- CLI --

def _parsed(cli, monkeypatch, argv, command):
    """The Namespace ``cli.main(argv)`` hands its ``command`` handler."""
    seen = []
    monkeypatch.setattr(cli, command, lambda a: seen.append(a) or 0)
    assert cli.main(argv) == 0
    return seen[0]


@pytest.mark.parametrize("extra", [
    [], ["--params-yaml", "P"], ["--params-yaml", "P", "--patchwork-yaml", "W"],
    ["--auto-radii", "--lidar-type", "VLP-16"], ["--lidar-type", "VLP-16"],
    ["--refine", "--refine-yaw-only"], ["--ground-alignment"],
    ["--reg-type", "TEASER", "--num-hypotheses", "4", "--no-subclustering",
     "--ground-mode", "LeGO-LOAM", "--noise-bound", "0.5"],
], ids=["defaults", "params-yaml", "both-yaml", "auto-radii", "vlp16",
        "refine", "ground-alignment", "solver-flags"])
def test_cli_build_config_matches_jax(tmp_path, monkeypatch, extra):
    p, pw = _yaml_files(tmp_path)
    argv = ["register", "--synthetic", "--max-voxels", "2048",
            "--max-correspondences", "256"] + [
        {"P": p, "W": pw}.get(a, a) for a in extra]
    targs = _parsed(tcli, monkeypatch, argv + ["--device", "cpu"],
                    "cmd_register")
    jargs = _parsed(jcli, monkeypatch, argv, "cmd_register")
    assert targs.device == "cpu"
    assert config_to_dict(tcli._build_config(targs)) == dataclasses.asdict(
        jcli._build_config(jargs))


def _captured_call(monkeypatch, module, name, result):
    calls = []

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return result
    monkeypatch.setattr(module, name, spy)
    return calls


def _run_quiet(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _as_plain(v):
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if isinstance(v, tuple):
        return tuple(_as_plain(x) for x in v)
    return v


@pytest.mark.parametrize("argv,name", [
    (["evaluate", "--n-pairs", "7", "--lidar-type", "VLP-16", "--batch", "4",
      "--tilt-deg", "3", "--ground-alignment", "--refine", "--terrain-slope",
      "0.05", "--num-vote-hypotheses", "2", "--vote-yaw-modes", "2",
      "--cache-dir", "C"], "evaluate_loop_closures"),
    (["overlap", "--baselines", "3", "6", "--n-pairs", "2",
      "--num-hypotheses", "2", "--cache-dir", "C"], "evaluate_overlap_sweep"),
    (["sweep", "--rates", "0.5", "0.9", "--n-trials", "6", "--n-corr",
      "128", "--seed", "2"], "evaluate_outlier_robustness"),
], ids=["evaluate", "overlap", "sweep"])
def test_cli_eval_commands_match_jax(tmp_path, monkeypatch, argv, name):
    """Each eval subcommand hands its harness the JAX CLI's arguments and
    configuration (the harness replaced by a recorder), plus the device."""
    argv = [str(tmp_path) if a == "C" else a for a in argv]

    class Report:
        def summary(self):
            return {"n_pairs": 0}

    result = Report() if name == "evaluate_loop_closures" else {}
    t_calls = _captured_call(monkeypatch, teval, name, result)
    j_calls = _captured_call(monkeypatch, jeval, name, result)
    t_out = _run_quiet(tcli.main, argv + ["--device", "cpu"])
    j_out = _run_quiet(jcli.main, argv)
    assert t_out == j_out
    (t_args, t_kw), = t_calls
    (j_args, j_kw), = j_calls
    assert t_kw.pop("device") == "cpu"
    assert [_as_plain(a) for a in t_args] == [_as_plain(a) for a in j_args]
    assert {k: _as_plain(v) for k, v in t_kw.items()} == \
        {k: _as_plain(v) for k, v in j_kw.items()}


def test_cli_sequence_matches_jax(tmp_path, monkeypatch):
    """``sequence --synthetic``: the same configuration and run arguments,
    and the same JSON line, TUM poses and trajectory PLY bytes for one
    result (the sequence and its solve replaced by recorders)."""
    import quatro_tpu.sequence as jseq
    import quatro_tpu_torch.sequence as tseq

    res = SequenceResult(
        poses=np.array([[0.0, 0.0, 0.0, 0.0], [1.0, 0.5, 0.1, 0.3],
                        [2.0, 0.2, 0.0, 1.2]]),
        odometry_poses=np.zeros((3, 4)), edges_total=3, edges_valid=2,
        ate_before=0.25, ate_after=float("nan"), wall_s=1.5,
        edges_i=np.array([0, 1, 0]), edges_j=np.array([1, 2, 2]),
        edge_mask=np.array([True, True, False]))
    outs = {}
    calls = {}
    for tag, cli, seq in (("t", tcli, tseq), ("j", jcli, jseq)):
        monkeypatch.setattr(seq, "make_synthetic_sequence",
                            lambda **kw: ([None] * 3, None))
        calls[tag] = _captured_call(monkeypatch, seq, "run_sequence", res)
        argv = ["sequence", "--synthetic", "3", "--lidar-type", "VLP-16",
                "--auto-radii", "--max-voxels", "2048", "--batch-size", "4",
                "--poses-out", str(tmp_path / f"{tag}.tum"),
                "--trajectory-ply", str(tmp_path / f"{tag}.ply")]
        outs[tag] = _run_quiet(cli.main, argv + (["--device", "cpu"]
                                                 if tag == "t" else []))
    assert outs["t"].replace("t.tum", "j.tum") == outs["j"]
    (t_args, t_kw), = calls["t"]
    (j_args, j_kw), = calls["j"]
    assert t_kw.pop("device") == "cpu"
    assert _as_plain(t_args[1]) == _as_plain(j_args[1])
    assert t_kw == j_kw
    for ext in ("tum", "ply"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()


def test_cli_register_end_to_end(tmp_path, monkeypatch):
    """``register --synthetic`` at VLP-16 on the CPU: the stage table, the
    ten PLY artifacts (tests/test_cli.py:30-40), and a transform equal bit
    for bit to the port's register_scan_pair on the same pair and
    configuration."""
    argv = ["register", "--synthetic", "--seed", "3", "--lidar-type",
            "VLP-16", "--auto-radii", "--max-raw-points", "32768",
            "--max-voxels", "2048", "--max-correspondences", "256",
            "--device", "cpu", "--dump-dir", str(tmp_path), "--json"]
    out = _run_quiet(tcli.main, argv)
    assert "# of raw cloud" in out and "estimated transform" in out
    assert "steady-state solve" in out and "total" in out
    res = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
    assert res["valid"] is True
    for name in ("source.ply", "target.ply", "aligned.ply",
                 "correspondences.ply", "max_clique_source.ply",
                 "max_clique_target.ply", "final_inliers.ply",
                 "ground_source.ply"):
        assert (tmp_path / name).stat().st_size > 100, name
    for name in ("revert_pc.ply", "reject_pc.ply"):
        assert (tmp_path / name).exists(), name
    assert len(os.listdir(tmp_path)) == 10

    cfg = tcli._build_config(_parsed(tcli, monkeypatch, argv, "cmd_register"))
    src, tgt, _ = make_scan_pair(seed=3, lidar=cfg.lidar)
    ref = register_scan_pair(PointBatch.from_numpy(src, 32768),
                             PointBatch.from_numpy(tgt, 32768), cfg,
                             device="cpu")
    np.testing.assert_array_equal(
        np.asarray(res["transform"], np.float32),
        ref.solution.transform().numpy())
    assert res["n_correspondences"] == int(ref.correspondences.mask.sum())


# ------------------------------------------------------------------- eval --

def test_pose_error_tilt_and_overlap_equal_jax(rng):
    for _ in range(4):
        yaw, ang = rng.uniform(-np.pi, np.pi, 2)
        t = np.eye(4)
        t[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        t[:3, 3] = rng.normal(size=3)
        gt = t.copy()
        gt[:2, :2] = [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
        for dtype in (np.float32, np.float64):
            assert teval._pose_error(t.astype(dtype), gt) == \
                jeval._pose_error(t.astype(dtype), gt)
    src = rng.normal(size=(300, 3)).astype(np.float32) * 10
    tgt = rng.normal(size=(280, 3)).astype(np.float32) * 10
    gt = np.eye(4, dtype=np.float32)
    got = teval._tilt_pair(src, tgt, gt, 5.0, np.random.default_rng(7))
    want = jeval._tilt_pair(src, tgt, gt, 5.0, np.random.default_rng(7))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    s, t2, g2 = got
    for kw in ({}, dict(radius=1.0, sample=100, seed=3)):
        assert teval.measured_overlap(s, t2, g2, **kw) == \
            jeval.measured_overlap(s, t2, g2, **kw)


@pytest.mark.parametrize("case", ["mixed", "all-failed"])
def test_eval_report_summary_equal_jax(case):
    rows = [(0, True, 0.5, 0.1, 120, True, True),
            (1, True, 7.5, 0.3, 80, False, False),
            (2, False, 0.2, 0.05, 3, False, False),
            (3, True, 1.5, 0.4, 99, True, False)]
    if case == "all-failed":
        rows = [r[:5] + (False, False) for r in rows]
    t = teval.EvalReport([teval.PairEval(*r) for r in rows], 1.7, 3.25)
    j = jeval.EvalReport([jeval.PairEval(*r) for r in rows], 1.7, 3.25)
    assert t.summary() == j.summary()
    assert (t.success_rate, t.strict_rate, t.pairs_per_s) == \
        (j.success_rate, j.strict_rate, j.pairs_per_s)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("batch", [1, 2])
def test_loop_closure_pairs_equal_jax(monkeypatch, batch):
    """evaluate_loop_closures draws the same seeds, yaws, translations and
    tilts in both packages: make_scan_pair and _tilt_pair are recorded, and
    the first registration stops the run, so the JAX side compiles
    nothing. With batch > 1 every pair is drawn before the first call;
    with batch == 1, the warm-up pair."""
    def spies(syn_mod, eval_mod, pipe_mod, log):
        real_tilt = eval_mod._tilt_pair

        def fake_pair(**kw):
            log.append(("pair", {k: _as_plain(v) for k, v in kw.items()}))
            pts = np.arange(30, dtype=np.float32).reshape(10, 3)
            return pts, pts + 1.0, np.eye(4, dtype=np.float32)

        def tilt(*args):
            out = real_tilt(*args)
            log.append(("tilt", out))
            return out

        def stop(*args, **kwargs):
            raise _Stop

        monkeypatch.setattr(syn_mod, "make_scan_pair", fake_pair)
        monkeypatch.setattr(eval_mod, "_tilt_pair", tilt)
        monkeypatch.setattr(pipe_mod, "register_scan_pair", stop)

    t_log, j_log = [], []
    spies(teval, teval, teval, t_log)
    spies(jsyn, jeval, jpipe, j_log)
    kw = dict(n_pairs=5, config=VLP_CFG, seed0=3, raw_capacity=64,
              trans_range=4.0, tilt_deg=5.0, batch=batch)
    with pytest.raises(_Stop):
        teval.evaluate_loop_closures(device="cpu", **kw)
    import quatro_tpu.config as jcfg
    jkw = dict(kw, config=jcfg.PipelineConfig(
        lidar=jcfg.LidarConfig.preset("VLP-16"), max_voxels=2048,
        max_raw_points=32768, fpfh=jcfg.FPFHConfig.for_lidar(
            jcfg.LidarConfig.preset("VLP-16"), max_correspondences=256)))
    with pytest.raises(_Stop):
        jeval.evaluate_loop_closures(**jkw)
    assert [e[0] for e in t_log] == [e[0] for e in j_log]
    assert len(t_log) == (10 if batch > 1 else 1)
    for (kind, t), (_, j) in zip(t_log, j_log):
        if kind == "pair":
            assert t.keys() == j.keys()
            for k in t:
                assert np.array_equal(t[k], j[k]) if k == "translation" \
                    else t[k] == j[k], k
        else:
            for a, b in zip(t, j):
                np.testing.assert_array_equal(a, b)


def test_outlier_robustness_equal_jax():
    """tests/test_eval.py:70-77 on both packages: equal success rates and
    inlier counts, medians within MEDIAN_TOL, at least 5/6 successes."""
    kw = dict(outlier_rates=[0.5, 0.9], n_trials=6, n_corr=128)
    got = teval.evaluate_outlier_robustness(device="cpu", **kw)
    want = jeval.evaluate_outlier_robustness(**kw)
    assert set(got) == set(want) == {0.5, 0.9}
    for rate in got:
        g, w = got[rate], want[rate]
        for k in ("success_rate", "n_inliers", "n_trials"):
            assert g[k] == w[k], (rate, k)
        for k in ("median_rot_err_deg", "median_trans_err_m"):
            assert abs(g[k] - w[k]) <= MEDIAN_TOL, (rate, k, g[k], w[k])
        assert g["success_rate"] >= 5 / 6, (rate, g)


def test_evaluate_scaling_one_card():
    res = teval.evaluate_scaling(batch_per_device=2, n_corr=64, iters=1,
                                 device="cpu")
    assert set(res) == {1} and res[1]["pairs_per_s"] > 0
    assert res[1]["efficiency"] == 1.0
    with pytest.raises(ValueError, match="one card"):
        teval.evaluate_scaling(device_counts=[1, 2], device="cpu")


def test_loop_closures_batched_equal_per_pair(tmp_path, monkeypatch):
    """evaluate_loop_closures(n_pairs=3) at VLP-16 on the CPU, batch=2
    (two calls over the pair axis, the last padded with its first pair)
    against batch=1: every row's valid and correspondence count equal,
    errors within ROW_DEG / ROW_M, at least 2 of 3 successful. The pairs
    go through the cache_dir process pool once."""
    shapes = []

    def recording(src, tgt, *args, **kwargs):
        shapes.append(tuple(src.points.shape))
        return register_scan_pair(src, tgt, *args, **kwargs)

    monkeypatch.setattr(teval, "register_scan_pair", recording)
    kw = dict(n_pairs=3, config=VLP_CFG, raw_capacity=32768,
              trans_range=4.0, cache_dir=str(tmp_path), device="cpu")
    batched = teval.evaluate_loop_closures(batch=2, **kw)
    assert shapes == [(2, 32768, 3)] * 2
    assert len(list(tmp_path.glob("pair_*.npz"))) == 3
    single = teval.evaluate_loop_closures(batch=1, **kw)
    assert shapes[2:] == [(32768, 3)] * 4
    assert [p.seed for p in batched.pairs] == [0, 1, 2]
    for b, s in zip(batched.pairs, single.pairs):
        assert (b.seed, b.valid, b.n_corr) == (s.seed, s.valid, s.n_corr)
        assert abs(b.rot_err_deg - s.rot_err_deg) <= ROW_DEG
        assert abs(b.trans_err_m - s.trans_err_m) <= ROW_M
    s = batched.summary()
    assert s["n_pairs"] == 3 and s["success_rate"] >= 2 / 3, s
    assert batched.wall_s > 0 and batched.compile_s > 0
