"""The einsum engine in plain PyTorch: FK, CRBA, RNEA, contacts, solve,
integrate (counterpart of ``pbrl_tpu/engine``)."""

from pbrl_tpu_torch.engine.data import Contact, Data, make_data  # noqa: F401
from pbrl_tpu_torch.engine.forward import forward, integrate, step, step_n  # noqa: F401
from pbrl_tpu_torch.engine import collision, dynamics, kinematics, solver  # noqa: F401
