"""VSlamSettings — the engine's 41 tunables with reference defaults
(``cv-sfm/src/settings.rs:7-264`` and the ``default_*``
functions at ``:320-483``).  A frozen dataclass; ``from_json``/``to_json``
accept partial documents exactly like the reference's serde defaults.
Carried over unchanged from ``cv_tpu/sfm/settings.py``: the same JSON
schema, so settings cross between the two packages by ``to_json``.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class VSlamSettings:
    # Feature extraction
    akaze_threshold: float = 1e-3
    # Landmark / observation robustness
    maximum_cosine_distance: float = 1e-5
    maximum_sine_distance: float = 1e-1
    robust_view_bearing_pair_minimum_cosine_distance: float = 1e-2
    robust_view_num_robust_bearing_pair: int = 3
    minimum_robust_landmarks: int = 32
    robust_minimum_observations: int = 3
    robust_observation_incidence_minimum_cosine_distance: float = 1e-3
    # Single-view (PnP) registration
    single_view_consensus_threshold: float = 1e-5
    single_view_optimization_num_matches: int = 1 << 11
    single_view_filter_loop_iterations: int = 5
    single_view_patience: int = 100_000
    single_view_initial_features: int = 1 << 13
    single_view_optimization_rate: float = 1e-3
    single_view_minimum_landmarks: int = 1 << 5
    single_view_minimum_robust_landmarks: int = 1 << 6
    single_view_match_better_by: int = 24
    # Two-view initialization
    two_view_consensus_threshold: float = 1e-7
    two_view_minimum_robust_matches: int = 1 << 8
    two_view_match_better_by: int = 24
    two_view_optimization_maximum_matches: int = 1 << 9
    two_view_patience: int = 1 << 12
    # Three-view initialization
    three_view_patience: int = 1 << 16
    three_view_minimum_relative_scales: int = 1 << 4
    three_view_filter_loop_iterations: int = 1 << 3
    three_view_optimization_landmarks: int = 1 << 10
    three_view_minimum_robust_matches: int = 32
    # Reconstruction optimization
    reconstruction_optimization_iterations: int = 1
    # Engine-only knob (no reference counterpart): defer the fused BA +
    # observation-filter fetch to the next engine call, overlapping its
    # device time with the next frame's host work.
    # Results are identical to the synchronous path (tests gate it); the
    # only visible difference is that reconstruction state read DIRECTLY
    # off ``VSlamData`` between engine calls may be one BA pass stale —
    # every engine entry point (and ``VSlam.flush_pending``) finalizes it.
    async_optimize: bool = True
    # Tracking
    tracking_features: int = 1 << 13
    tracking_similar_frames: int = 0
    tracking_similar_frame_recent_threshold: int = 0
    tracking_similar_frame_search_num: int = 1 << 9
    tracking_recent_frames: int = 32
    # Graph optimization
    optimization_maximum_three_view_constraints: int = 1 << 6
    optimization_minimum_new_constraints: int = 4
    optimization_iterations: int = 1 << 10
    optimization_minimum_landmarks: int = 24
    optimization_maximum_landmarks: int = 64
    optimization_robust_covisibility_minimum_landmarks: int = 1 << 4
    graph_optimization_rate: float = 0.001
    constraint_patience: int = 1 << 12

    @classmethod
    def from_json(cls, text: str) -> "VSlamSettings":
        """Partial JSON works — absent fields keep their defaults, matching
        the reference's per-field serde defaults."""
        doc = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def replace(self, **kwargs) -> "VSlamSettings":
        return dataclasses.replace(self, **kwargs)
