"""Multi-device execution: mesh helpers + distributed bundle adjustment.

No analogue in the reference (its only parallelism is two CPU threads,
src/Initializer.cpp:64-67 — SURVEY.md §2.3); built per BASELINE.json
configs 3-5: keyframe/landmark blocks partitioned over a jax.sharding.Mesh,
reduced camera system assembled with psum collectives over ICI/DCN.
"""

from orbslam_in_practice.parallel.dist_ba import (  # noqa: F401
    partition_ba_problem,
    dist_bundle_adjustment,
)
