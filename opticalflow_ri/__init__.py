"""opticalflow_ri — dense optical flow engine for PIV in JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of the reference
library OpticalFlow-RI (calibrated dense optical flow for fluid-mechanics PIV
image pairs, max displacement <= 4 px): four solvers (Horn-Schunck, Liu-Shen
physics-based refinement, dense windowed Lucas-Kanade, Farneback polynomial
expansion) composed under a generic coarse-to-fine pyramidal warping driver.

Reference parity map (see SURVEY.md):
  - pyramid driver    -> opticalflow_ri.pyramid        (ref: src/GenericPyramidalOpticalFlow.py)
  - Horn-Schunck      -> opticalflow_ri.models.horn_schunck   (ref: src/HornSchunck.py)
  - Liu-Shen          -> opticalflow_ri.models.liu_shen       (ref: src/PhysicsBasedOpticalFlowLiuShen.py)
  - dense Lucas-Kanade-> opticalflow_ri.models.lucas_kanade   (ref: src/denseLucasKanade_PyCL.py + pyrlkDenseLargeW.cl)
  - Farneback         -> opticalflow_ri.models.farneback      (ref: src/Farneback_PyCL.py + optical_flow_farneback.cl)
  - calibrated filters-> opticalflow_ri.ops.gaussian          (ref: src/gaussian_filter.py)
  - bit-exact kernels -> opticalflow_ri.ops.kernels_bitexact  (ref: src/GaussianKernelBitExact.py)

Unlike the single-device reference, solvers scale over device meshes through
``opticalflow_ri.parallel`` (spatial domain decomposition with ppermute
halo exchange + batch data parallelism).
"""

from opticalflow_ri.pyramid import (
    generic_pyramidal_optical_flow,
    GenericPyramidalOpticalFlowWrapper,
)
from opticalflow_ri.models.horn_schunck import HSOpticalFlowAlgoAdapter
from opticalflow_ri.models.liu_shen import LiuShenOpticalFlowAlgoAdapter
from opticalflow_ri.models.lucas_kanade import DenseLucasKanadeAdapter
from opticalflow_ri.models.farneback import FarnebackAdapter

__version__ = "0.1.0"

__all__ = [
    "generic_pyramidal_optical_flow",
    "GenericPyramidalOpticalFlowWrapper",
    "HSOpticalFlowAlgoAdapter",
    "LiuShenOpticalFlowAlgoAdapter",
    "DenseLucasKanadeAdapter",
    "FarnebackAdapter",
]
