"""One ``MimicVecEnv.step`` with held-torque PD (``pd_per_substep=False``:
one Stable-PD torque per env from the pre-step state, held over the
substeps) against pbrl_tpu's ``backend="xla"`` env, on the port's kernel
backend (its plain version on the CPU, in ``torque`` mode) and on its
engine backend (tests/test_torch_vec_engine.py's setup and tolerances).
"""

from test_torch_vec_engine import assert_step_matches, step_pair


def test_held_torque_pd_matches_jax():
    """Held-torque PD: the kernel backend (its plain version here, in torque
    mode, launching nothing) and the engine backend."""
    js2, out, envs = step_pair({"pd_per_substep": False}, backends=("kernel", "xla"))
    assert envs["kernel"]._kspec.mode == "torque" and envs["kernel"]._kstep.launches == 0
    assert not hasattr(envs["xla"], "_kstep")
    for backend, ts2 in out.items():
        assert_step_matches(ts2, js2)
