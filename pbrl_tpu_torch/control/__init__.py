"""Controllers: standard, inverse-dynamics, Stable and implicit PD, cubic
trajectories (counterpart of ``pbrl_tpu/control``)."""

from pbrl_tpu_torch.control.pd import (  # noqa: F401
    Gains,
    clamp_torque,
    implicit_pd,
    inverse_dynamics_pd,
    masked_torque,
    stable_pd,
    standard_pd,
    torque_to_qfrc,
)
from pbrl_tpu_torch.control.trajectory import (  # noqa: F401
    constant_trajectories,
    cubic_coefficients,
    evaluate,
    evaluate_velocity,
    set_trajectories,
)
from pbrl_tpu_torch.mocap.skeleton import generate_kp_kd_gains  # noqa: F401


def default_gains(dtype=None) -> Gains:
    """Reference humanoid PD gains as a :class:`Gains` pair (float32 numpy)."""
    import numpy as np

    kp, kd = generate_kp_kd_gains()
    dtype = dtype or np.float32
    return Gains(kp=np.asarray(kp, dtype), kd=np.asarray(kd, dtype))
