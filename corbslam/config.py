"""Typed configuration tree for the whole framework.

Replaces the reference's two config mechanisms — OpenCV FileStorage YAML
(ref: corbslam_client/src/Tracking.cc:52-146) and hardcoded constants
scattered through source (ORBmatcher.cc:37-38 TH_LOW/TH_HIGH, Cache.cc:370
sync period, MapFusion.cpp:319,434 rates, KeyFrame.cc:49 id stride) — with
one dataclass tree. Every tunable the reference had lives here, with the
reference's defaults.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class OrbConfig:
    """ORB extractor budget (ref: Examples/Stereo/KITTI00-02.yaml ORBextractor.*)."""

    # Reference budget is 2000 (KITTI yaml); this config budgets 2048, which
    # must equal CapacityConfig.max_features (keyframe SoA row width).
    n_features: int = 2048
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    cell_size: int = 16  # grid cell for spatial spreading (px, per level)

    def features_per_level(self):
        """Geometric budget over levels, mirrors ORBextractor ctor
        (ORBextractor.cc:442-460)."""
        inv = 1.0 / self.scale_factor
        w = [inv ** i for i in range(self.n_levels)]
        total = sum(w)
        n = [int(round(self.n_features * wi / total)) for wi in w]
        # Round to multiples of 8 for clean tiling; fix total drift on level 0.
        n = [max(8, (x // 8) * 8) for x in n]
        n[0] += self.n_features - sum(n)
        return n

    def scales(self):
        return [self.scale_factor ** i for i in range(self.n_levels)]


@dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching thresholds (ref: ORBmatcher.cc:37-38 and call sites)."""

    th_low: int = 50
    th_high: int = 100
    nn_ratio_tracking: float = 0.9
    nn_ratio_mapping: float = 0.6
    check_orientation: bool = True
    rot_hist_bins: int = 30  # HISTO_LENGTH (ORBmatcher.h:95)
    search_radius_motion: float = 15.0  # projection window, px (x level scale)
    search_radius_reloc: float = 15.0


@dataclass(frozen=True)
class TrackingConfig:
    """Front-end policy (ref: Tracking.cc NeedNewKeyFrame:995, thresholds inline)."""

    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30  # = fps in the reference
    min_tracked_points: int = 30
    min_inliers_motion: int = 10
    min_matches_reloc: int = 15
    th_depth: float = 35.0  # close/far stereo point split (KITTI yaml ThDepth)
    kf_ref_ratio_stereo: float = 0.75  # thRefRatio (Tracking.cc:1046-1053)
    kf_ref_ratio_mono: float = 0.9
    # Frames in flight before the host syncs a frame's summary. Depth 2
    # hides the dispatch and sync round trip behind one frame of device
    # compute; host-visible state (trajectory, keyframe policy) lags by
    # this many frames.
    pipeline_depth: int = 2
    # Consecutive frames chained inside ONE fused device program (2 =
    # track_ops.track_frame_stereo2), halving the dispatch count.
    # Host-visible state (keyframe policy, trajectory) lags
    # pipeline_depth frames as before.
    frames_per_dispatch: int = 1


@dataclass(frozen=True)
class MappingConfig:
    """Local mapping policy (ref: LocalMapping.cc)."""

    recent_point_min_found_ratio: float = 0.25  # MapPointCulling:171
    recent_point_max_unobserved_kfs: int = 2
    triangulation_max_reproj_chi2: float = 5.991
    local_ba_window: int = 16  # covisible KFs in local BA
    # 5 LM iterations x <=16 warm-started tolerance-exited CG iterations:
    # local BA re-runs on every keyframe over overlapping windows, so
    # convergence accrues across keyframes; the reference's 5+10 schedule
    # (Optimizer.cc:711,758) budgets one window optimized once.
    local_ba_iters: int = 5
    local_ba_cg_iters: int = 16
    kf_cull_redundancy: float = 0.9  # KeyFrameCulling:590 (90% rule)


@dataclass(frozen=True)
class LoopConfig:
    """Loop closing / place recognition (ref: LoopClosing.cc, MapFusion.cpp)."""

    covisibility_consistency_th: int = 3  # LoopClosing.cc:64
    min_bow_matches: int = 15  # MapFusion.cpp:692
    min_sim3_inliers: int = 20  # GlobalOptimize.cpp:150
    min_total_matches: int = 40  # GlobalOptimize.cpp:211
    pose_graph_iters: int = 20  # OptimizeEssentialGraph (Optimizer.cc:1032)
    global_ba_iters: int = 10  # GlobalOptimize.cpp:444
    gba_obs_per_kf: int = 512  # dense-plane GBA per-keyframe obs budget
    # Truncated-CG LM: warm-started, tolerance-exited CG capped per LM
    # iteration — LM is robust to inexact inner solves, and each CG
    # iteration costs a full gather pass over the observation planes.
    # 24 is the quality knee on the loop-e2e orbit (16 -> ate_kf 0.084,
    # 24/32 -> 0.076 = the converged optimum; 48 LM iters change nothing).
    gba_cg_iters: int = 24


@dataclass(frozen=True)
class CollabConfig:
    """Client/server collaboration (ref: Cache.cc, MapFusion.cpp, PubToClient.cpp)."""

    client_id_stride: int = 1_000_000  # KeyFrame.cc:49 id partitioning
    uplink_period_s: float = 6.0  # Cache.cc:370
    broadcast_period_s: float = 2.0  # MapFusion.cpp:319 (0.5 Hz)
    fusion_scan_period_s: float = 2.0  # MapFusion.cpp:434
    resend_chunk_kfs: int = 50  # MapFusion.cpp:403
    resend_chunk_mps: int = 2000  # MapFusion.cpp:407
    max_clients: int = 16


@dataclass(frozen=True)
class CapacityConfig:
    """Fixed device-array capacities (the answer to dynamic map growth,
    SURVEY.md §5.7). Sized for a full KITTI sequence per client."""

    max_keyframes: int = 2048
    max_map_points: int = 131072
    max_features: int = 2048  # per keyframe (>= OrbConfig.n_features)
    local_window_kfs: int = 32
    local_window_mps: int = 8192


@dataclass(frozen=True)
class SlamConfig:
    orb: OrbConfig = field(default_factory=OrbConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    collab: CollabConfig = field(default_factory=CollabConfig)
    capacity: CapacityConfig = field(default_factory=CapacityConfig)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


KITTI_STEREO = SlamConfig()

TUM_RGBD = SlamConfig(
    orb=OrbConfig(n_features=1000),
    tracking=TrackingConfig(th_depth=3.0, max_frames_between_kf=30),
)
