"""Levenberg-Marquardt back-end replacing the reference's g2o usage.

(reference: src/Optimizer.cpp — g2o BlockSolver_6_3 + LM; here: analytic
Jacobians, Schur landmark marginalization, lax control flow.)
"""

from orbslam_in_practice.optim.pose_opt import pose_optimization  # noqa: F401
from orbslam_in_practice.optim.ba import bundle_adjustment  # noqa: F401
from orbslam_in_practice.optim.pose_graph import optimize_pose_graph  # noqa: F401
