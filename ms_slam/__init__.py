"""MS-SLAM in JAX: a stereo / stereo-inertial visual SLAM framework.

A from-scratch JAX/XLA re-design of the capability set of MS-SLAM
(fishmarch/MS-SLAM, an ORB-SLAM3-derived system with sliding-window map
sparsification). The compute path is functional and jit-compiled: batched
feature kernels, Gauss-Newton/Schur bundle adjustment, and an LP-relaxation
map-point selector replace the reference's per-feature C++ loops, g2o, and
GUROBI. Map state lives in fixed-capacity structure-of-arrays pools with
validity masks so every kernel sees static shapes.

Layer map (mirrors SURVEY.md of the reference):
  ops/       geometry + feature + optimization kernels   (ref L1, L3)
  models/    map data model: pools, frames, vocabulary   (ref L2)
  pipeline/  tracking / local mapping / sparsification / loop closing / system
             (ref L4, L5)
  parallel/  device-mesh sharding, distributed BA        (no ref counterpart)
  utils/     config, datasets, trajectory IO, evaluation (ref L8, L9)
"""

__version__ = "0.1.0"

import jax as _jax

# On the GPU, f32 matmuls would otherwise run in TF32 (~10 mantissa bits);
# geometry and normal-equation math (3x3 rotation chains, Schur assembly)
# needs true f32, and reduced-precision products visibly diverge bundle
# adjustment. Descriptor matmuls are unaffected (their inputs are already
# bf16).
_jax.config.update("jax_default_matmul_precision", "float32")
