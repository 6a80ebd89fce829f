"""Pure-jnp geometry core: SE3/Sim3, camera models, multi-view solvers.

Replaces the Eigen-based geometry of the reference (src/Initializer.cpp,
src/PnPsolver.cpp, src/Sim3Solver.cpp, src/Converter.cpp) with batched,
jit-friendly closed forms.
"""

from orbslam_in_practice.geometry.se3 import (  # noqa: F401
    hat,
    exp_so3,
    log_so3,
    exp_se3,
    log_se3,
    se3_inverse,
    se3_compose,
    transform_points,
    quat_to_rot,
    rot_to_quat,
    make_se3,
)
from orbslam_in_practice.geometry.camera import (  # noqa: F401
    project,
    unproject,
    distort_radtan,
    undistort_points,
)
from orbslam_in_practice.geometry.triangulate import (  # noqa: F401
    triangulate_dlt,
)
from orbslam_in_practice.geometry.twoview import (  # noqa: F401
    normalize_points,
    eight_point,
    homography_dlt,
    decompose_E,
    decompose_H,
)
from orbslam_in_practice.geometry.epnp import epnp  # noqa: F401
from orbslam_in_practice.geometry.sim3 import horn_sim3  # noqa: F401
