"""Typed configuration + OpenCV-FileStorage-compatible YAML loader.

The reference reads its settings with cv::FileStorage from YAML files whose
schema is fixed by Example/TUM1.yaml (reference Tracking.cc:44-169,
SurfelMapping.cpp:30-41, Viewer.cc).  We load the exact same files (including
the ``%YAML:1.0`` header that stock pyyaml rejects) into one frozen dataclass
that every subsystem shares, instead of each subsystem re-reading the file.

Capacity constants (the fixed tensor shapes of the device step) live here too: the reference has
implicit caps (1000 keypoints, 40 lines, ~tens of planes) that we turn into
explicit padded-array capacities.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field

import numpy as np


def _parse_opencv_yaml(text: str) -> dict:
    """Parse an OpenCV FileStorage YAML file into a flat {key: value} dict.

    Handles the ``%YAML:1.0`` directive line and the flat ``Key.Sub: value``
    scheme used by all reference configs.  Values become int/float/str.
    """
    out: dict = {}
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line or line.startswith("%"):
            continue
        m = re.match(r"^([A-Za-z0-9_.]+)\s*:\s*(.+)$", line)
        if not m:
            continue
        key, val = m.group(1), m.group(2).strip()
        if val.startswith('"') and val.endswith('"'):
            out[key] = val[1:-1]
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics + radial-tangential distortion (Camera.* keys)."""

    fx: float = 517.306408
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0
    bf: float = 40.0  # stereo baseline * fx (reference Camera.bf)
    rgb: int = 1

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))

    @property
    def baseline(self) -> float:
        return self.bf / self.fx


@dataclass(frozen=True)
class OrbConfig:
    """ORBextractor.* keys (reference Tracking.cc:113-121)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7

    def features_per_level(self) -> list[int]:
        """Geometric feature budget per pyramid level.

        Same allocation rule as the reference extractor ctor
        (ORBextractor.cc:435-452): nFeatures split by factor 1/scale per
        level, remainder to the coarsest level.
        """
        inv = 1.0 / self.scale_factor
        n_desired = self.n_features * (1 - inv) / (1 - inv**self.n_levels)
        per = []
        total = 0
        for _ in range(self.n_levels - 1):
            k = int(round(n_desired))
            per.append(k)
            total += k
            n_desired *= inv
        per.append(max(self.n_features - total, 0))
        return per


@dataclass(frozen=True)
class PlaneConfig:
    """Plane.* keys (reference Tracking.cc:139-169)."""

    association_dis_ref: float = 0.05
    association_ang_ref: float = 0.985
    vertical_threshold: float = 0.08716
    parallel_threshold: float = 0.9962
    angle_info: float = 0.5
    distance_info: float = 50.0
    chi: float = 100.0
    vp_chi: float = 50.0
    parallel_info: float = 0.5
    vertical_info: float = 0.5
    distance_threshold: float = 0.04
    mf_vertical_threshold: float = 0.01

    @property
    def angle_info_mat(self) -> float:
        """Info weight used for plane angle residuals.

        The reference derives 3282.8/(angle_info_deg^2) (Tracking.cc:158-169).
        """
        return 3282.8 / (self.angle_info * self.angle_info)


@dataclass(frozen=True)
class LineConfig:
    """Line.* keys (ours — the reference hard-codes these inside
    LSDextractor/LSDmatcher/LocalMapping; exposed as a config block like
    Plane.* so they can be tuned per dataset without code edits)."""

    # detector gates (ops/lines.py; the reference's LSD keeps top-40 by
    # response, LSDextractor.cpp:23-31 — these gate the Hough redesign)
    mag_threshold: float = 40.0  # Sobel magnitude floor for edge pixels
    min_support: int = 15  # min supporting edge pixels per segment
    min_density: float = 0.2  # support pixels per unit length
    min_length: float = 20.0  # pixels at detection resolution
    # association windows (device tracker; LSDmatcher projection windows)
    assoc_mid_px: float = 40.0  # midpoint projection window
    assoc_ang_deg: float = 12.0  # angular window
    # duplicate-fusion gates (LocalMapping fuse_lines; LSDmatcher::Fuse)
    fuse_desc_sim: float = 0.85
    fuse_ang_deg: float = 8.0
    fuse_mid_m: float = 0.15


@dataclass(frozen=True)
class SurfelConfig:
    """Surfel.* keys + superpixel constants (SurfelFusion.h:34-39)."""

    distance_far: float = 30.0
    distance_near: float = 0.5
    sp_size: int = 8  # superpixel seed spacing in pixels
    drift_free_poses: int = 10  # BFS window (SurfelMapping.h:29)
    max_surfels: int = 262144  # capacity of the surfel array (ours; power of 2)


@dataclass(frozen=True)
class CapacityConfig:
    """Static-shape capacities for the padded device arrays (ours).

    The reference's implicit caps: 1000 kps (config), top-40 lines
    (LSDextractor.cpp:23-31), minSupport 3000 pts/plane → <=16 planes
    per frame in practice, <=100 new points / 30 lines per KF
    (Tracking.cc:1566,:1615).
    """

    max_keypoints: int = 1024
    max_lines: int = 64
    max_planes_frame: int = 8
    max_plane_points: int = 512  # downsampled inlier cloud per frame plane
    max_map_points: int = 32768
    max_map_lines: int = 2048
    max_map_planes: int = 64
    max_map_plane_points: int = 4096  # merged cloud per map plane
    max_keyframes: int = 512
    max_local_keyframes: int = 80
    max_local_points: int = 8192
    max_local_lines: int = 512


@dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    plane: PlaneConfig = field(default_factory=PlaneConfig)
    line: LineConfig = field(default_factory=LineConfig)
    surfel: SurfelConfig = field(default_factory=SurfelConfig)
    caps: CapacityConfig = field(default_factory=CapacityConfig)
    th_depth: float = 40.0  # close/far point threshold, baseline multiples
    depth_map_factor: float = 5000.0
    # keyframe-policy hysteresis (NeedNewKeyFrame, Tracking.cc:1433-1508):
    # the reference's mMinFrames=0 works because its c1b gate also requires
    # the (asynchronous) mapper to be idle; our mapping backend is
    # synchronous, so a small explicit min interval plays that role.
    min_kf_frames: int = 5
    save_path_frame: str = "CameraTrajectory.txt"
    save_path_keyframe: str = "KeyFrameTrajectory.txt"

    @property
    def th_depth_m(self) -> float:
        """Close-point depth threshold in meters (bf/fx * ThDepth)."""
        return self.camera.baseline * self.th_depth


def load_config(path: str) -> SlamConfig:
    """Load a reference-format YAML settings file (Example/*.yaml schema)."""
    with open(path, "r") as f:
        kv = _parse_opencv_yaml(f.read())
    return config_from_dict(kv)


def config_from_dict(kv: dict) -> SlamConfig:
    def g(key, default):
        return kv.get(key, default)

    cam = CameraConfig(
        fx=float(g("Camera.fx", 517.306408)),
        fy=float(g("Camera.fy", 516.469215)),
        cx=float(g("Camera.cx", 318.643040)),
        cy=float(g("Camera.cy", 255.313989)),
        k1=float(g("Camera.k1", 0.0)),
        k2=float(g("Camera.k2", 0.0)),
        p1=float(g("Camera.p1", 0.0)),
        p2=float(g("Camera.p2", 0.0)),
        k3=float(g("Camera.k3", 0.0)),
        width=int(g("Camera.width", 640)),
        height=int(g("Camera.height", 480)),
        fps=float(g("Camera.fps", 30.0)),
        bf=float(g("Camera.bf", 40.0)),
        rgb=int(g("Camera.RGB", 1)),
    )
    orb = OrbConfig(
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
    )
    plane = PlaneConfig(
        association_dis_ref=float(g("Plane.AssociationDisRef", 0.05)),
        association_ang_ref=float(g("Plane.AssociationAngRef", 0.985)),
        vertical_threshold=float(g("Plane.VerticalThreshold", 0.08716)),
        parallel_threshold=float(g("Plane.ParallelThreshold", 0.9962)),
        angle_info=float(g("Plane.AngleInfo", 0.5)),
        distance_info=float(g("Plane.DistanceInfo", 50.0)),
        chi=float(g("Plane.Chi", 100.0)),
        vp_chi=float(g("Plane.VPChi", 50.0)),
        parallel_info=float(g("Plane.ParallelInfo", 0.5)),
        vertical_info=float(g("Plane.VerticalInfo", 0.5)),
        distance_threshold=float(g("Plane.DistanceThreshold", 0.04)),
        mf_vertical_threshold=float(g("Plane.MFVerticalThreshold", 0.01)),
    )
    line = LineConfig(
        mag_threshold=float(g("Line.MagThreshold", 40.0)),
        min_support=int(g("Line.MinSupport", 15)),
        min_density=float(g("Line.MinDensity", 0.2)),
        min_length=float(g("Line.MinLength", 20.0)),
        assoc_mid_px=float(g("Line.AssocMidPx", 40.0)),
        assoc_ang_deg=float(g("Line.AssocAngDeg", 12.0)),
        fuse_desc_sim=float(g("Line.FuseDescSim", 0.85)),
        fuse_ang_deg=float(g("Line.FuseAngDeg", 8.0)),
        fuse_mid_m=float(g("Line.FuseMidM", 0.15)),
    )
    surf = SurfelConfig(
        distance_far=float(g("Surfel.distanceFar", 30.0)),
        distance_near=float(g("Surfel.distanceNear", 0.5)),
    )
    return SlamConfig(
        camera=cam,
        orb=orb,
        plane=plane,
        line=line,
        surfel=surf,
        th_depth=float(g("ThDepth", 40.0)),
        depth_map_factor=float(g("DepthMapFactor", 5000.0)),
        save_path_frame=str(g("SavePath.Frame", "CameraTrajectory.txt")),
        save_path_keyframe=str(g("SavePath.Keyframe", "KeyFrameTrajectory.txt")),
    )


def replace(cfg, **kw):
    """dataclasses.replace passthrough (convenience for tests)."""
    return dataclasses.replace(cfg, **kw)
