"""Physics ops: the field program (plain PyTorch), the CUDA policy step
(``ops.mimic_kernel``, imported by name: it builds nothing at import) and
the batched SPD linear algebra."""

from pbrl_tpu_torch.ops.linalg import cholesky_factor, cholesky_solve, solve_spd  # noqa: F401
