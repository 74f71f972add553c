"""flame_tpu — a dense monocular depth-mesh estimation framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
robustrobotics/flame (FLaME: Fast Lightweight Mesh Estimation,
Greene & Roy ICCV'17): given a posed monocular image stream, estimate a
dense inverse-depth mesh at frame rate by combining

  * gradient-salient feature detection on a grid,
  * per-feature epipolar inverse-depth filtering (LSD-SLAM style),
  * Delaunay graph construction over the features,
  * NLTGV2-L1 variational smoothing solved by Chambolle-Pock primal-dual
    iteration, and
  * barycentric mesh rasterization into dense inverse-depth maps.

Where the reference (C++11, OpenCV/Eigen/Sophus/Boost, 3 threads + OpenMP +
SSE) mutates shared graph state, flame_tpu uses fixed-capacity
structure-of-arrays state with validity masks and a functional per-frame
step, so the whole hot path jit-compiles onto the accelerator. The only
host-side
stage is Delaunay triangulation (native C++, `flame_tpu/native`).

Beyond the reference, flame_tpu adds windowed bundle adjustment over
keyframe poses (`flame_tpu.ba`), multi-device sharding of the smoothing
and BA solves (`flame_tpu.parallel`), checkpointing, and a structured
stats/tracing layer.
"""

from flame_tpu.params import (
    Params,
    FilterParams,
    LineStereoParams,
    MeasModelParams,
    RegularizerParams,
    TriangleFilterParams,
    DetectionParams,
    SolverParams,
    BAParams,
)
from flame_tpu.core.flame import Flame
from flame_tpu.utils.stats import StatsTracker

__version__ = "0.1.0"

__all__ = [
    "Flame",
    "Params",
    "FilterParams",
    "LineStereoParams",
    "MeasModelParams",
    "RegularizerParams",
    "TriangleFilterParams",
    "DetectionParams",
    "SolverParams",
    "BAParams",
    "StatsTracker",
]
