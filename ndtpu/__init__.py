"""ndtpu — 2D laser SLAM engine in JAX.

A from-scratch re-engineering of the capability set of the reference
``sven-glory/GTSAM-NDT`` pipeline (NDT scan-matching frontend + GTSAM
pose-graph/iSAM backend; see SURVEY.md §1-§4) as batched, static-shape
JAX/XLA tensor programs, run on an NVIDIA GPU:

- ``ndtpu.lie``     — SE(2) Lie-group ops on ``[..., 3]`` pose tensors
                      (capability of GTSAM ``gtsam/geometry/Pose2``).
- ``ndtpu.ndt``     — NDT grid-map construction (segment_sum scatter) and
                      batched Gauss-Newton/LM scan registration
                      (capability of the reference's NDT frontend).
- ``ndtpu.graph``   — factor-graph SoA, batched linearization, Gauss-Newton /
                      Levenberg-Marquardt / PCG solvers, incremental smoother
                      (capability of GTSAM nonlinear/linear/inference layers
                      + ISAM2).
- ``ndtpu.loop``    — loop-closure candidate generation + batched NDT
                      verification.
- ``ndtpu.slam``    — SLAM orchestration: jitted odometry scan loop,
                      keyframing, online map build.
- ``ndtpu.dist``    — multi-device/multi-host sharding: mesh construction,
                      sharded batched registration, grid-block map build,
                      distributed Schur-complement pose-graph solve.
- ``ndtpu.data``    — CARMEN log parser, g2o parser, synthetic lidar
                      simulator, Manhattan-world pose-graph generator.
- ``ndtpu.eval``    — ATE / RPE trajectory metrics (Umeyama alignment).

The reference checkout was empty when this project was designed (SURVEY.md
§0); behavioral parity claims cite SURVEY.md sections (which carry their own
provenance tags) instead of reference file:line.
"""

__version__ = "0.1.0"
