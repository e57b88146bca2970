"""The port's engine step against pbrl_tpu's, from the same humanoid
states (tests/test_torch_engine.py's: joint noise, velocities, a lifted
env, a tilted root) under implicit PD; ``step_n`` is held in
tests/test_torch_engine_step_n.py (each is one XLA compile of tens of
seconds on the CPU, so they run as two files).

pbrl_tpu's step is vmapped and jitted. Tolerances are pbrl_tpu's own
cross-engine ones (tests/test_field_physics.py): one substep qpos 1e-6,
qvel 2e-4.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pbrl_tpu.engine  # noqa: F401
import pbrl_tpu_torch.engine  # noqa: F401
from pbrl_tpu.control import default_gains as j_gains
from pbrl_tpu.control import implicit_pd as j_implicit_pd
from pbrl_tpu.engine import data as jdata
from pbrl_tpu.model import humanoid_model as j_humanoid
from pbrl_tpu_torch.control import default_gains, implicit_pd
from pbrl_tpu_torch.engine.data import make_data
from pbrl_tpu_torch.model import humanoid_model
from test_torch_engine import humanoid_states

jfwd = sys.modules["pbrl_tpu.engine.forward"]
tfwd = sys.modules["pbrl_tpu_torch.engine.forward"]


def _run(n):
    jm, tm = j_humanoid(), humanoid_model()
    qpos, qvel, target = humanoid_states(4, seed=5)
    jg = j_gains()

    def one(q, v, u):
        d = jdata.make_data(jm, qpos=q, qvel=v)
        pd = lambda mm, dd: j_implicit_pd(mm, dd, u, jg)
        return jfwd.step(jm, d, qfrc_fn=pd) if n == 1 else jfwd.step_n(jm, d, n, qfrc_fn=pd)

    jd = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in (qpos, qvel, target)))
    u = torch.from_numpy(target)
    d = make_data(tm, torch.from_numpy(qpos), torch.from_numpy(qvel))
    pd = lambda mm, dd: implicit_pd(mm, dd, u, default_gains())
    td = tfwd.step(tm, d, qfrc_fn=pd) if n == 1 else tfwd.step_n(tm, d, n, qfrc_fn=pd)
    assert int((np.asarray(jd.contact.dist) < 0).sum()) > 0  # contacts touch
    return jd, td


def test_step_matches_jax():
    jd, td = _run(1)
    np.testing.assert_allclose(td.qpos.numpy(), np.asarray(jd.qpos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(td.qvel.numpy(), np.asarray(jd.qvel), atol=2e-4, rtol=0)
    np.testing.assert_allclose(td.time.numpy(), np.asarray(jd.time), atol=0, rtol=0)
