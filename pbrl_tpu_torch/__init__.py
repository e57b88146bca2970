"""PyTorch/CUDA port of ``pbrl_tpu`` (TPU-native physics-based RL).

The JAX package ``pbrl_tpu`` stays the reference; this package mirrors its
module names so each counterpart is easy to find, and imports only
``torch``, ``numpy`` and the standard library. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.

The policy step of the vectorized mimic env is one hand-written CUDA
kernel (``csrc/mimic_step.cu``, wrapped by :mod:`pbrl_tpu_torch.ops.
mimic_kernel`); everything around it is plain PyTorch, the einsum engine
(:mod:`pbrl_tpu_torch.engine`, the env's ``backend="xla"`` and the
per-env envs) included.
"""
