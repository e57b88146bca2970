"""One ``MimicVecEnv.step`` of the engine backend with inverse-dynamics PD
against pbrl_tpu's ``backend="xla"`` env from shared reset states
(tests/test_torch_vec_engine.py's setup and tolerances).
"""

from test_torch_vec_engine import assert_step_matches, step_pair


def test_engine_backend_inverse_dynamics_pd_matches_jax():
    js2, out, _ = step_pair({"controller": "inverse_dynamics_pd"})
    assert_step_matches(out["xla"], js2)
