"""The yardstick's arithmetic: the card's published peaks, the operations
and bytes the step needs, and the shares they give.

The kernel's needed FLOP per env come from the frozen counter in
:mod:`benchmark.reference.field_physics` (``count_policy_step_flops`` over
``contact_activity``: what these inputs need, a contact's Delassus mass
only where it touches), run on the reference's plain program. Its bytes
count each input read once and each output written once:
``4 B (2 (nq + nv) + nu + 7 nbody + 1)`` a launch.
"""

from __future__ import annotations

import torch

from benchmark.reference import field_physics as fp

# NVIDIA H100 SXM data sheet: dense rates, full 700 W power limit.
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12


def mlp_forward(widths) -> int:
    """FLOP of one row through a dense MLP of these widths: 2·in·out a layer."""
    return sum(2 * a * b for a, b in zip(widths, widths[1:]))


def kernel_flop_per_env(spec, qpos, qvel, u) -> float:
    """Needed FLOP per env of one policy step from these launch inputs."""
    active = fp.contact_activity(spec, qpos, qvel, u)
    return fp.count_policy_step_flops(spec, active) / qpos.shape[0]


def kernel_bytes(spec, batch: int) -> int:
    return 4 * batch * (2 * (spec.nq + spec.nv) + spec.nu + 7 * spec.nbody + 1)


def kernel_least_s(spec, flop_per_env: float, batch: int):
    """(least seconds of one launch, the bound that sets it)."""
    t_ops = flop_per_env * batch / PEAK_FLOPS["fp32"]
    t_bytes = kernel_bytes(spec, batch) / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations at 67 TFLOP/s f32" if t_ops >= t_bytes
                                 else "bytes at 3.35 TB/s")


def matmul_precision() -> str:
    """The precision the run's float32 matmuls ran in."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest")
    return "tf32" if tf32 else "fp32"


def step_mfu_pct(model_flops: dict, seconds: float, matmul: str) -> float:
    """Σ over precisions of model FLOP over that precision's peak, over
    the window's seconds, in %: the MLPs at the matmul precision, the
    kernel's vector f32 at the f32 peak."""
    need = model_flops["matmul"] / PEAK_FLOPS[matmul] + model_flops["vector"] / PEAK_FLOPS["fp32"]
    return 100.0 * need / seconds
