from .plausibility import (  # noqa: F401
    animate_optimization,
    optimize_trajectory,
    rank_trajectories,
    sample_candidate_trajs,
    score_trajectories,
)
