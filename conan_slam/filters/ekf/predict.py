"""EKF time update (motion prediction).

Reference: ``EKF::predict`` (EKF.cpp:406-455).  The covariance propagation is
*structured*: only the 3x3 pose block and the pose-map cross strip change,

    Pvv <- Gv Pvv Gv^T + Gu Q Gu^T
    Pvm <- Gv Pvm            (full 2K width — the reference propagates one
                              column short, ``P.cols()-4``, EKF.cpp:442-443;
                              SURVEY.md defect 5 — fixed here)

so the cost is O(K), not the O(D^2) a dense G P G^T would pay.
"""

from __future__ import annotations

import jax.numpy as jnp

from conan_slam.core.linalg import PRECISION, mm, sym
from conan_slam.filters.ekf.state import EKFState
from conan_slam.models import motion


def predict(state: EKFState, v, swa, q_cov, wheel_base, dt) -> EKFState:
    gv, gu = motion.jacobians(state.pose, v, swa, wheel_base, dt)

    p = state.p
    pvv = p[:3, :3]
    pvm = p[:3, 3:]

    pvv_new = sym(mm(mm(gv, pvv), gv.T) + mm(mm(gu, q_cov), gu.T))
    pvm_new = jnp.matmul(gv, pvm, precision=PRECISION)

    p = p.at[:3, :3].set(pvv_new)
    p = p.at[:3, 3:].set(pvm_new)
    p = p.at[3:, :3].set(pvm_new.T)

    x = state.x.at[:3].set(motion.step(state.pose, v, swa, wheel_base, dt))
    return state._replace(x=x, p=p)
