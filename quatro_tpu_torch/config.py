"""Configuration tree for the PyTorch port of the quatro-tpu pipeline.

A field-by-field mirror of ``quatro_tpu/config.py`` (the JAX package's
config imports its package, which pulls in jax, so the port keeps its own
copy; tests/test_torch_config.py pins every field and default against
it). ``config_from_dict`` / ``config_to_dict`` carry a configuration
across: ``dataclasses.asdict`` of a JAX ``PipelineConfig`` is plain
Python and builds the same port ``PipelineConfig``.

The reference spreads configuration over two YAML files loaded into the ROS
parameter server (reference: config/params.yaml, config/patchwork_params.yaml,
launch/quatro.launch:3-4) plus the solver's ``Quatro::Params`` struct
(reference: include/quatro.hpp:202-268).  Here everything is a tree of frozen
dataclasses: hashable, so any config can be a static argument to ``jax.jit``,
and every capacity that shapes an array is an explicit static field.

Unlike the reference, array capacities are first-class: XLA requires static
shapes, so each pipeline stage declares a hard cap + validity mask instead of
dynamically sized ``pcl::PointCloud``s.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class LidarConfig:
    """Per-sensor range-image geometry.

    Mirrors the five sensor models of the reference
    (reference: include/imageProjection.hpp:85-124).
    """

    name: str = "Velodyne-64-HDE"
    n_scan: int = 64
    horizon_scan: int = 1800
    ang_res_x: float = 360.0 / 1800
    ang_res_y: float = 26.9 / 63
    ang_bottom: float = 25.0
    ground_scan_ind: int = 60

    @staticmethod
    def preset(name: str) -> "LidarConfig":
        presets = {
            "Velodyne-64-HDE": dict(n_scan=64, horizon_scan=1800,
                                    ang_res_x=360.0 / 1800, ang_res_y=26.9 / 63,
                                    ang_bottom=25.0, ground_scan_ind=60),
            "VLP-16": dict(n_scan=16, horizon_scan=1800, ang_res_x=0.2,
                           ang_res_y=2.0, ang_bottom=15.1, ground_scan_ind=7),
            "HDL-32E": dict(n_scan=32, horizon_scan=1800,
                            ang_res_x=360.0 / 1800, ang_res_y=41.33 / 31,
                            ang_bottom=30.67, ground_scan_ind=20),
            "Ouster-OS1-16": dict(n_scan=16, horizon_scan=1024,
                                  ang_res_x=360.0 / 1024, ang_res_y=33.2 / 15,
                                  ang_bottom=16.7, ground_scan_ind=7),
            "Ouster-OS1-64": dict(n_scan=64, horizon_scan=1024,
                                  ang_res_x=360.0 / 1024, ang_res_y=33.2 / 63,
                                  ang_bottom=16.7, ground_scan_ind=15),
        }
        if name not in presets:
            raise ValueError(f"Unknown lidar type: {name!r}; options: {sorted(presets)}")
        return LidarConfig(name=name, **presets[name])


@dataclass(frozen=True)
class PatchworkConfig:
    """Concentric-Zone-Model ground segmentation parameters.

    Mirrors config/patchwork_params.yaml and the constructor defaults of
    ``PatchWork`` (reference: include/patchwork.hpp:47-140).
    """

    sensor_height: float = 1.723
    num_iter: int = 3
    num_lpr: int = 20
    num_min_pts: int = 80
    th_seeds: float = 0.25
    th_dist: float = 0.125
    max_r: float = 80.0
    min_r: float = 2.7
    uprightness_thr: float = 0.707
    adaptive_seed_selection_margin: float = -1.1
    using_global_elevation: bool = False
    global_elevation_threshold: float = -0.5
    num_zones: int = 4
    num_sectors_each_zone: Tuple[int, ...] = (16, 32, 54, 32)
    num_rings_each_zone: Tuple[int, ...] = (2, 4, 4, 4)
    min_ranges_each_zone: Tuple[float, ...] = (2.7, 12.3625, 22.025, 41.35)
    # Indexed with `ring_idx + 2 * zone_idx` exactly like the reference
    # (reference: include/patchwork.hpp:407-408).
    elevation_thresholds: Tuple[float, ...] = (-1.2, -0.9984, -0.851, -0.605)
    flatness_thresholds: Tuple[float, ...] = (0.0001, 0.000125, 0.000185, 0.000185)
    # Static capacity: max points binned per CZM patch (reference caps at
    # NUM_HEURISTIC_MAX_PTS_IN_PATCH=3000, include/patchwork.hpp:20).
    max_pts_per_patch: int = 1024

    def __post_init__(self):
        n = self.num_zones
        if not (len(self.num_sectors_each_zone) == len(self.num_rings_each_zone)
                == len(self.min_ranges_each_zone) == n):
            raise ValueError("CZM zone parameter lists must all have num_zones entries")
        if self.min_r != self.min_ranges_each_zone[0]:
            raise ValueError("min_r must equal min_ranges_each_zone[0]")
        if len(self.elevation_thresholds) != len(self.flatness_thresholds):
            raise ValueError("elevation/flatness threshold lists must match in size")

    @property
    def num_patches(self) -> int:
        return sum(r * s for r, s in
                   zip(self.num_rings_each_zone, self.num_sectors_each_zone))

    @property
    def num_rings_of_interest(self) -> int:
        # reference: include/patchwork.hpp:108
        return len(self.elevation_thresholds)

    @property
    def ring_boundaries(self) -> Tuple[float, ...]:
        """Outer radius of each zone: (min_r1..min_r4, max_r)."""
        return tuple(self.min_ranges_each_zone) + (self.max_r,)


@dataclass(frozen=True)
class ProjectionConfig:
    """Range-image sub-clustering parameters.

    Mirrors the constants of ``ImageProjection``
    (reference: include/imageProjection.hpp:58-64,28).
    """

    neighbor_mode: str = "4CrossNeighbor"  # 4Neighbor | 8Neighbor | 4CrossNeighbor
    min_pts_for_subcluster: int = 30
    segment_valid_point_num: int = 5
    segment_valid_line_num: int = 3
    segment_theta_deg: float = 60.0
    min_range: float = 0.1
    # Label-propagation iteration cap for the connected-components solve that
    # replaces the reference's serial BFS (include/imageProjection.hpp:485-581).
    # With pointer-jumping the label graph converges in O(log(diameter)) rounds.
    max_cc_iters: int = 48

    def __post_init__(self):
        if self.neighbor_mode not in ("4Neighbor", "8Neighbor", "4CrossNeighbor"):
            raise ValueError(f"bad neighbor_mode {self.neighbor_mode!r}")

    @property
    def neighbor_offsets(self) -> Tuple[Tuple[int, int], ...]:
        # reference: include/imageProjection.hpp:169-195
        if self.neighbor_mode == "4Neighbor":
            return ((-1, 0), (0, 1), (0, -1), (1, 0))
        if self.neighbor_mode == "8Neighbor":
            return ((-1, 0), (0, 1), (0, -1), (1, 0),
                    (-1, -1), (-1, 1), (1, 1), (1, -1))
        return ((-1, -1), (-1, 1), (1, 1), (1, -1))


@dataclass(frozen=True)
class FPFHConfig:
    """FPFH descriptor + matcher parameters.

    Radii mirror config/params.yaml:23-25; the constraint check mirrors
    fpfh_manager.hpp:99-102. The tuple test is a deterministic re-design of
    the reference's srand(time(NULL)) sampling
    (reference: src/teaser_utils/feature_matcher.cc:187-247).
    """

    normal_radius: float = 0.5
    fpfh_radius: float = 0.75
    # Static neighbor capacity for radius queries (replaces kd-tree lists).
    max_neighbors_normal: int = 48
    max_neighbors_fpfh: int = 64
    use_crosscheck: bool = True
    # Robustness addition: when fewer than this many MUTUAL matches
    # survive the crosscheck, fall back to the one-directional union
    # candidate set (measured eval failure: a hard pair produced 18
    # mutual matches with ONE GT-consistent — starvation no solver-side
    # mechanism can recover from). 0 disables the fallback.
    crosscheck_min_matches: int = 64
    # Robustness addition: when the tuple test keeps fewer than this many
    # pairs, skip it and hand the NN candidates to the solver (whose
    # clique stage is the stronger outlier filter). The reference
    # proceeds with whatever survives and aborts downstream
    # (quatro.hpp:809-813). On degenerate-descriptor pairs the tuple
    # test measurably KEEPS only one self-consistent (wrong) structure
    # — a higher floor trades match precision for the recall those
    # pairs need.
    tuple_min_keep: int = 48
    use_tuple_test: bool = True
    tuple_scale: float = 0.95
    tuple_trials_per_corr: int = 100
    tuple_seed: int = 0
    # Static cap on matched correspondences fed to the solver.
    max_correspondences: int = 1024
    # Fused Pallas normals/SPFH/FPFH kernels (ops/pallas_frontend.py):
    # None = auto (on for TPU backends, where the XLA dense form's HBM
    # traffic is the pipeline bottleneck); the dense XLA path stays the
    # CPU/test oracle.
    use_pallas_frontend: Optional[bool] = None

    def __post_init__(self):
        if self.normal_radius > self.fpfh_radius:
            raise ValueError("normal_radius must be <= fpfh_radius "
                             "(reference: fpfh_manager.hpp:99-102)")

    @classmethod
    def for_lidar(cls, lidar: "LidarConfig", ref_range: float = 15.0,
                  **overrides) -> "FPFHConfig":
        """Sensor-appropriate radii, scaled by elevation ring spacing.

        The reference's defaults (0.5 / 0.75, config/params.yaml:23-25) are
        tuned for a 64-beam HDL-64E whose rings are ~0.11 m apart at 15 m.
        Sparser sensors (VLP-16: ~0.52 m at 15 m) need proportionally larger
        radii or normal patches degenerate to single rings — this mirrors
        the reference's per-sensor YAML tuning guidance
        (config/params.yaml:17-44) as a formula: the normal radius covers
        >=~2 ring gaps at `ref_range` meters, floored at the KITTI defaults.
        """
        import math
        ring_gap = ref_range * math.radians(lidar.ang_res_y)
        scale = max(1.0, 2.0 * ring_gap / 0.5)
        kwargs = dict(normal_radius=round(0.5 * scale, 3),
                      fpfh_radius=round(0.75 * scale, 3))
        kwargs.update(overrides)
        return cls(**kwargs)


@dataclass(frozen=True)
class SolverConfig:
    """Robust registration back-end parameters.

    Mirrors ``Quatro::Params`` (reference: include/quatro.hpp:202-268) plus
    the two implicit noise-bound quirks of the reference made explicit:

    * the GNC rotation stage runs with ``noise_bound * rotation_noise_bound_scale``
      (the reference multiplies params.noise_bound by 2/scale before the solve,
      include/quatro.hpp:846-852, and latches it in a function-local static,
      include/quatro.hpp:469);
    * COTE uses ``noise_bound * cote_noise_bound_coeff`` (the reference uses the
      constructor-initialised member ``noise_bound_`` = 0.3,
      include/quatro.hpp:115,600-601).
    """

    # Params-struct parity notes (include/quatro.hpp:202-268): the
    # reference also declares rotation_tim_graph (CHAIN|COMPLETE), but only
    # the CHAIN branch is implemented upstream (quatro.hpp:817 has no else
    # — COMPLETE leaves the TIM buffers empty), so it is inert there and
    # chain TIMs are simply the behavior here; use_max_clique /
    # max_clique_exact_solution are deprecated upstream in favor of
    # inlier_selection_mode; max_clique_time_limit caps PMC's
    # branch-and-bound wall-clock, which has no analog in the data-parallel
    # clique search (max_clique_size bounds the growth loop instead).
    reg_name: str = "Quatro"          # "Quatro" (yaw-only) or "TEASER" (full SO(3))
    cote_mode: str = "median"         # "median" (Quatro) or "weighted_mean" (TEASER++)
    using_rot_inliers_when_estimating_cote: bool = False
    noise_bound: float = 0.3
    cbar2: float = 1.0
    estimate_scaling: bool = False
    # "GNC_TLS" (reference default) or "FGR" (Geman-McClure) —
    # ROTATION_ESTIMATION_ALGORITHM, include/quatro.hpp:172-175.
    rotation_estimation_algorithm: str = "GNC_TLS"
    rotation_gnc_factor: float = 1.4
    rotation_max_iterations: int = 50
    rotation_cost_threshold: float = 0.00011
    rotation_noise_bound_scale: float = 2.0
    cote_noise_bound_coeff: float = 1.0
    # Inlier selection (replacement for PMC max-clique, src/graph.cc:12-130):
    # "clique" = k-core peel + batched greedy clique growth; "kcore" = k-core
    # filter only (KCORE_HEU analog); "exact" = branch-and-bound over the
    # k-core restriction, warm-started from the greedy clique (PMC_EXACT
    # analog, src/graph.cc:106-127 — for small-N/offline parity runs);
    # "none" = all scale-inliers pass.
    inlier_selection_mode: str = "clique"
    # "exact" mode knobs: the search runs on the `exact_clique_cap`
    # top-scored k-core vertices and is truncated at `exact_clique_max_steps`
    # branch-and-bound iterations (the analog of pmc's
    # max_clique_time_limit; the incumbent so far is still returned).
    exact_clique_cap: int = 64
    exact_clique_max_steps: int = 20000
    kcore_heuristic_threshold: float = 0.5
    # Number of parallel greedy-growth seeds for the clique search. All
    # seeds grow in lock-step ((S,N)@(N,N) MXU matmuls), so large S is nearly
    # free; 128 is what it takes to find a planted 5-clique whose vertex
    # degrees sit below the spurious-outlier degree tail at 99% outliers
    # (measured: 16 seeds -> 10/64 failures there, 128 -> 0/64).
    clique_num_seeds: int = 128
    # (1,2)-swap local-improvement rounds applied to the top greedy cliques
    # after growth (solver/clique.py::improve_cliques_1swap). Closes most of
    # the residual regret vs exact branch-and-bound (PMC_EXACT analog,
    # reference src/graph.cc:106-127) for a couple of O(N^2) steps; 0 = off.
    clique_swap_rounds: int = 2
    # The consistency-graph kernel (B1, ops/kernels.py). None = auto: the
    # kernel on the card at any N, the plain graph on the CPU; True: the
    # kernel (its plain version on the CPU); False: the plain graph, which
    # runs on the CPU only and raises ValueError on the card.
    use_pallas_graph: Optional[bool] = None
    # Static cap on clique size (bounds the greedy-growth loop).
    max_clique_size: int = 512
    # Multi-hypothesis registration (beyond the reference): solve the K
    # largest mutually-distinct cliques and let the pipeline arbitrate by
    # geometric overlap (solver/verify.py). Repetitive structure can make
    # the WRONG clique the largest (planar aliasing); >1 recovers those
    # pairs at ~K x solver cost (the solver is ~1/3 of pipeline time).
    # Honored by pipeline.register_features / register_scan_pair and
    # OdometryRunner (which have the clouds to verify against);
    # register_correspondences alone always solves the single best clique.
    num_hypotheses: int = 1
    # Clique-INDEPENDENT hypotheses from (yaw, translation) voting
    # (solver/vote.py): planar aliasing can bury the correct consensus
    # set below the top K cliques entirely (measured at K=8, RESULTS.md
    # round 4), so extra hypotheses of the same kind cannot recover it.
    # The vote path reads the modal yaw off the consistency graph's
    # edges, then emits the top translation modes at that yaw as
    # additional support masks; the same overlap arbitration picks the
    # winner. 0 disables. Cost is ~1 extra GNC+COTE polish + 1 overlap
    # check per hypothesis.
    num_vote_hypotheses: int = 0
    # Translation vote bin edge, in units of noise_bound.
    vote_trans_bin_scale: float = 2.5
    vote_yaw_anchors: int = 64
    vote_yaw_bins: int = 256
    # Vote translations at the top-K yaw modes (a dominant aliased
    # structure can outvote the true yaw in the histogram). 1 = top mode
    # only (default). CAUTION: modes > 1 is CPU-validated but the n=300
    # on-chip eval program reproducibly hit a TPU device error with it
    # (round 5; the Mosaic composition-hazard family) — treat
    # as experimental on TPU until revalidated on a newer toolchain.
    vote_yaw_modes: int = 1

    def __post_init__(self):
        if self.reg_name not in ("Quatro", "TEASER"):
            raise ValueError("reg_name must be 'Quatro' or 'TEASER'")
        if self.cote_mode not in ("median", "weighted_mean"):
            raise ValueError("[COTE]: Wrong parameter comes!")
        if self.rotation_gnc_factor <= 1.0:
            raise ValueError("rotation_gnc_factor must be > 1")
        if self.rotation_estimation_algorithm not in ("GNC_TLS", "FGR"):
            raise ValueError("rotation algorithm must be GNC_TLS or FGR")
        if self.noise_bound == 0.0:
            raise ValueError("noise_bound must be nonzero")
        if self.inlier_selection_mode not in ("clique", "kcore", "exact",
                                              "none"):
            raise ValueError(f"bad inlier_selection_mode {self.inlier_selection_mode!r}")
        if self.num_hypotheses < 1:
            raise ValueError("num_hypotheses must be >= 1")
        if self.num_vote_hypotheses < 0:
            raise ValueError("num_vote_hypotheses must be >= 0")

    @property
    def total_hypotheses(self) -> int:
        """Clique + vote hypotheses actually solved by the multi-
        hypothesis path (pipeline gates on > 1)."""
        return self.num_hypotheses + self.num_vote_hypotheses


@dataclass(frozen=True)
class IcpConfig:
    """Point-to-plane ICP refinement of the coarse global pose.

    Extension beyond the reference: its README positions Quatro as the
    coarse initial alignment (reference: README.md:26-44); users then
    polish with PCL ICP off-line. This keeps the fine stage on-device
    (see solver/icp.py). Disabled by default for exact reference parity.
    """

    enabled: bool = False
    iterations: int = 12
    max_correspondence_distance: float = 1.0
    # Gate schedule: hold max_correspondence_distance for the first
    # `hold_iterations` (basin capture — coarse poses can start ~1 m off,
    # e.g. vertically ambiguous wall-feature matches), then anneal
    # geometrically down to final_correspondence_distance (precision —
    # rejects cross-surface matches that bias the point-to-plane optimum).
    # Measured on the sparse VLP-16 fixture with a 1.2 m coarse z error:
    # anneal-from-iter-0 leaves 1.1 m of it; hold-8-anneal-4 ends at 5 mm.
    hold_iterations: int = 8
    final_correspondence_distance: float = 0.3
    # Fixed-size source subsample: bounds the (K, V) distance matmul.
    max_source_points: int = 2048
    huber_delta: float = 0.3
    damping: float = 1e-6
    min_correspondences: int = 24
    # Restrict the update to yaw + translation (quasi-SO(3) contract).
    yaw_only: bool = False

    def __post_init__(self):
        if self.iterations < 1:
            raise ValueError("icp iterations must be >= 1")
        if self.max_correspondence_distance <= 0:
            raise ValueError("icp max_correspondence_distance must be > 0")


@dataclass(frozen=True)
class GroundAlignmentConfig:
    """Roll/pitch/z from the segmented ground (Quatro++, IJRR'24).

    Extension beyond the reference repo (which is yaw-only quasi-SO(3)
    with an optional IMU prior, include/quatro.hpp:276-279): level both
    scans by their fitted ground planes before the yaw solve, and read the
    vertical translation off the ground-height difference. Disabled by
    default for exact reference parity. See solver/ground.py.
    """

    enabled: bool = False
    # Gates on each scan's plane fit; a failing pair degrades to identity
    # leveling (yaw-only behavior) instead of failing.
    min_points: int = 256
    max_tilt_deg: float = 35.0      # reject walls masquerading as ground
    max_flatness: float = 0.01      # lambda_min / trace of the scatter
    # Replace COTE's correspondence-voted z with the closed-form
    # ground-height difference (every ground point votes for it).
    use_ground_z: bool = True

    def __post_init__(self):
        if self.min_points < 3:
            raise ValueError("ground alignment needs >= 3 points")
        if not (0.0 < self.max_tilt_deg < 90.0):
            raise ValueError("max_tilt_deg must be in (0, 90)")


@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline configuration with all static capacities."""

    lidar: LidarConfig = LidarConfig()
    patchwork: PatchworkConfig = PatchworkConfig()
    projection: ProjectionConfig = ProjectionConfig()
    fpfh: FPFHConfig = FPFHConfig()
    solver: SolverConfig = SolverConfig()
    icp: IcpConfig = IcpConfig()
    ground_alignment: GroundAlignmentConfig = GroundAlignmentConfig()
    ground_segmentation_mode: str = "Patchwork"  # "Patchwork" | "LeGO-LOAM"
    # Range-image sub-cluster rejection is the reference's FPFH speed
    # booster (README.md:102-104, "not presented in our paper") — it can
    # starve the matcher on sparse scenes. False keeps every non-ground
    # point for feature extraction (the TPU FPFH is cheap enough).
    use_subclustering: bool = True
    # Run src/tgt preprocessing as ONE vmapped chain at 2x batch. Twice
    # measured a REGRESSION (round 3: spill traffic; round 4 re-test at
    # half the HBM footprint: 48 vs 70 pairs/s — the stacked (2, N, 3)
    # copy pads its minor dim ~42x and swamps the op-count savings), so
    # the default is the two sequential chains. Kept as a knob because
    # the tradeoff may flip on hardware with different padding behavior.
    stack_preprocess: bool = False
    voxel_size: float = 0.3
    # Static capacities per stage.
    max_raw_points: int = 131072
    max_nonground_points: int = 65536
    max_segment_points: int = 32768
    max_voxels: int = 8192

    def __post_init__(self):
        if self.ground_segmentation_mode not in ("Patchwork", "LeGO-LOAM"):
            raise ValueError("Ground Segmentation mode is wrong!")

    @staticmethod
    def recommended(**overrides) -> "PipelineConfig":
        """The SHIPPING configuration — the exact ``PipelineConfig`` both
        round-5 headline artifacts measure: 0.990 loop-closure success at
        n=300 on-chip (EVAL_r05.json) and 73.7 pairs/s serving throughput
        (BENCH_SELF_r05.json; ``python bench.py`` defaults).

        Differs from the bare defaults only in the solver's hypothesis
        machinery: 4 clique hypotheses + 2 clique-independent (yaw,
        translation) vote hypotheses, arbitrated by geometric overlap.
        The bare ``PipelineConfig()`` default keeps the reference-parity
        single-clique solver (num_hypotheses=1), which is measurably
        faster (86.4 pairs/s) but loses planar-aliasing pairs the
        multi-hypothesis path recovers (0.9833 vs 0.990 at n=300).
        Pinned by tests/test_config.py::test_recommended_is_shipping.
        """
        solver = overrides.pop("solver",
                               SolverConfig(num_hypotheses=4,
                                            num_vote_hypotheses=2))
        return PipelineConfig(solver=solver, **overrides)

    @staticmethod
    def for_lidar(name: str, **overrides) -> "PipelineConfig":
        """Sensor-matched pipeline config: the lidar preset plus FPFH radii
        scaled to its ring spacing (``FPFHConfig.for_lidar``).

        The reference's 0.5/0.75 m radii are HDL-64E-specific tuning
        (config/params.yaml:17-44); on sparser sensors they starve the
        descriptors (measured: VLP-16 consecutive-scan inlier rate 2.5%
        with KITTI radii vs 7% with scaled radii — the difference between
        failed and sub-degree registrations on 45-degree-yaw pairs).
        """
        lidar = LidarConfig.preset(name)
        if "fpfh" not in overrides:
            overrides["fpfh"] = FPFHConfig.for_lidar(lidar)
        return PipelineConfig(lidar=lidar, **overrides)


def replace(cfg, **kwargs):
    """Functional update helper: ``replace(cfg, noise_bound=0.5)``."""
    return dataclasses.replace(cfg, **kwargs)


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = f.default if f.default is not dataclasses.MISSING else None
        if dataclasses.is_dataclass(sub):
            v = _from_dict(type(sub), v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**kwargs)


def config_from_dict(d: dict) -> PipelineConfig:
    """Build a ``PipelineConfig`` from nested plain-Python dicts, e.g.
    ``dataclasses.asdict`` of the JAX package's ``PipelineConfig``.
    Missing fields keep their defaults; unknown fields raise."""
    return _from_dict(PipelineConfig, d)


def config_to_dict(cfg: PipelineConfig) -> dict:
    """Nested plain-Python dict of a ``PipelineConfig`` (inverse of
    ``config_from_dict``)."""
    return dataclasses.asdict(cfg)


DEFAULT_CONFIG = PipelineConfig()
