"""Engine configuration — the typed replacement for the reference's
global `myCONFIG` struct (config_file.m:1-112).

Every flag in the reference's FLAGS block maps to a typed field here
(or is noted as intentionally dropped):

  EST_METHOD ('1PRE' | 'PURE_EKF')      → est_method
  FEATURE_EXTRACTOR ('SIFT' | 'FAST')   → feature_extractor
  MOTION_INPUT                          → motion_input (VO odometry vs none)
  DATA_PLAY (snapshot replay)           → utils/checkpoint.py replay
  OVERWRITE / RECALCULATE (disk caches) → dropped: no disk caches; the
                                          whole pipeline is one device
                                          program (SURVEY §5 checkpoint)
  CONFIDENCE_MAP                        → use_confidence
  ONLY_PREDICT                          → only_predict
  INITIAL_ORIENTATION_COMPENSATION      → plane-fit prior (backend/plane_fit)
  PLOT_RESULTS / DO_ANIM / VERBOSE      → host-side tooling flags

Frozen dataclass: hashable, usable as a jit static argument.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class FrontendConfig:
    extractor: str = "sift"  # "sift" | "fast"
    max_features: int = 288  # fast: top-k; sift: octaves × per-octave
    sift_octaves: int = 3
    sift_per_octave: int = 96
    sift_peak_thresh: float = 0.004
    sift_upright: bool = True
    fast_threshold: float = 0.05
    patch_size: int = 11
    min_depth: float = 0.4  # inittialize_depth_my_version.m:74
    confidence_ratio: float = 0.5
    use_confidence: bool = True


@dataclass(frozen=True)
class VoConfig:
    ransac_batch: int = 1024  # ref: ≤2000 sequential iterations
    sample_size: int = 4  # ransac_dr_ye.m 4-point hypotheses
    match_ratio: float = 1.3
    min_inliers: int = 8


@dataclass(frozen=True)
class EkfConfig:
    n_landmarks: int = 64
    std_z: float = 1.0  # px (mono_slam.m:78)
    ransac_batch: int = 256  # 1-pt RANSAC (ref ≤1000 adaptive)
    match_ratio: float = 1.5  # siftmatch.c default
    max_adds: int = 8
    min_measured: int = 25
    est_method: str = "1pre"  # "1pre" | "pure_ekf" (ekf_update_all path)
    motion_input: bool = True  # VO odometry drives prediction; False =
    # the Civera constant-velocity estimator (SlamConfig.motion_model="cv")
    only_predict: bool = False
    initial_orientation: bool = False  # INITIAL_ORIENTATION_COMPENSATION:
    # plane-fit gravity prior at bootstrap (SlamConfig.initial_orientation)
    heading_update_every: int = 0  # periodic floor-fit attitude update
    # (the reference's commented mono_slam.m:189-193 path)


@dataclass(frozen=True)
class EngineConfig:
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    vo: VoConfig = field(default_factory=VoConfig)
    ekf: EkfConfig = field(default_factory=EkfConfig)
    seed: int = 0
