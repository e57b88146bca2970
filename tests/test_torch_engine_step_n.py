"""The port's ``step_n`` against pbrl_tpu's over the 8 substeps of a
policy step in 'step' self-contact mode (substep 0's masses held by
substeps 1..7), from tests/test_torch_engine.py's humanoid states under
implicit PD. pbrl_tpu's is vmapped and jitted (its ``lax.scan``; the
port's is a Python loop). Tolerances as pbrl_tpu's cross-engine ones
(tests/test_field_physics.py): qpos 1e-5, qvel 1e-3.
"""

import numpy as np

from test_torch_engine_step import _run


def test_step_n_matches_jax():
    jd, td = _run(8)
    np.testing.assert_allclose(td.qpos.numpy(), np.asarray(jd.qpos), atol=1e-5, rtol=0)
    np.testing.assert_allclose(td.qvel.numpy(), np.asarray(jd.qvel), atol=1e-3, rtol=0)
