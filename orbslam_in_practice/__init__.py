"""orbslam_in_practice — a monocular SLAM engine in JAX for one GPU.

A from-scratch JAX/XLA re-design of the capability surface of the
reference ORB-SLAM practice codebase (Sunny-cpp/orbslam_In_practice):

- ORB feature front-end (pyramid + FAST + spatial top-k + orientation +
  rotated BRIEF) as batched, fixed-shape device compute
  (reference: src/ORBextractor.cpp).
- Hamming descriptor matching as an int8 matmul
  (reference: src/ORBmatcher.cpp).
- Two-view monocular initialization with vmapped RANSAC hypothesis batches
  (reference: src/Initializer.cpp).
- Levenberg-Marquardt bundle adjustment with Schur landmark marginalization,
  pose-only optimization with chi-square outlier gating
  (reference: src/Optimizer.cpp).
- Fixed-shape device-array world model replacing the pointer graph
  (reference: src/Map.cpp, src/KeyFrame.cpp, src/MapPoint.cpp).
- Tracking state machine + local mapping + loop closing
  (reference: src/Tracking.cpp, src/LocalMapping.cpp).
- Distributed bundle adjustment over a jax.sharding.Mesh with psum
  collectives (no analogue in the reference — per BASELINE.json configs).
"""

__version__ = "0.1.0"

# Geometry demands true float32: at default precision XLA:GPU may run f32
# matmuls and convolutions in TF32 (10-bit mantissa, ~1e-3 relative), which
# floors BA/pose accuracy and flips borderline BRIEF comparison bits.
# "highest" keeps them in full f32. The engine's throughput-critical
# matmuls are int8 (Hamming), which precision does not touch.
# Respect an explicit user/process-level choice: only set the default when
# none has been configured.
import jax as _jax

if _jax.config.jax_default_matmul_precision is None:
    _jax.config.update("jax_default_matmul_precision", "highest")


def __getattr__(name):
    # Lazy to keep `import orbslam_in_practice` cheap (no jax trace work).
    if name == "SlamSystem":
        from orbslam_in_practice.system import SlamSystem

        return SlamSystem
    raise AttributeError(name)
