"""conan_slam: a SLAM engine compiled to one device program (JAX / XLA).

Brand-new implementation of the capabilities of mfkiwl/conan-slam
(EKF-SLAM + FastSLAM 2.0 valet-parking simulator, reference at
upstream) redesigned for an accelerator: static-shape masked state, batched
kernels, vmapped particle ensembles, scan-based simulation, sharded
multi-chip execution.  See SURVEY.md for the reference analysis.
"""

from conan_slam.config import DEFAULT_CONFIG, SlamConfig

__version__ = "0.1.0"
__all__ = ["SlamConfig", "DEFAULT_CONFIG"]
