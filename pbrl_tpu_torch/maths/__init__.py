"""Math foundation: batched quaternion algebra and spatial helpers on torch
tensors."""

from pbrl_tpu_torch.maths import numeric, quaternion, spatial  # noqa: F401
from pbrl_tpu_torch.maths.numeric import safe_norm  # noqa: F401
