"""Device compute ops for the ORB front-end and matching.

jnp reference implementations + Pallas kernels for the hot paths
(SURVEY.md §2.2 mapping table). Each Pallas kernel has a jnp twin used for
parity tests and CPU execution.
"""

from orbslam_in_practice.ops.image import (  # noqa: F401
    gaussian_blur7,
    build_pyramid_shapes,
)
from orbslam_in_practice.ops.fast import fast_score  # noqa: F401
from orbslam_in_practice.ops.hamming import (  # noqa: F401
    pack_bits,
    unpack_to_pm1,
    hamming_matrix,
)
