"""``examples/quickstart_torch.py``, the port's tour, sections 1-3 on the
CPU in a subprocess, held against pbrl_tpu on the same inputs.

* Section 1, the sphere drop: its height after 1 s (500 substeps of
  ``engine.step_n``) within 1e-6 of pbrl_tpu's jitted ``step_n`` on the
  same scene. (Both give 0.096076 here, below the tour's "rests at 0.1".)
* Section 2, the replay of one walk cycle: 76 frames, the root 1.22 m on,
  as pbrl_tpu's tour prints.
* Section 3, Stable-PD tracking of the cubic elbow trajectories (1500
  substeps): the right elbow at the cubic's midpoint (t = 2 s, 500
  substeps, where the tracking lags the target) and at the end, each
  within 1e-5 of pbrl_tpu's own section-3 loop (``examples/quickstart.py``:
  ``implicit_pd`` through its engine ``step``, a jitted scan) on the same
  table and gains. The JAX side runs while the tour's subprocess does.

Sections 4 and 5 are ``tests/test_torch_tour_train.py``'s. One thread:
the engine's small ops run faster without a thread pool.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tour_cmd(*args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return dict(args=[sys.executable, os.path.join(ROOT, "examples", "quickstart_torch.py"),
                      "--device", "cpu", *args], cwd=ROOT, env=env)


def _finish(out, err, returncode):
    assert returncode == 0, err[-3000:]
    return out


def run_tour(*args, timeout=120):
    out = subprocess.run(**_tour_cmd(*args), capture_output=True, text=True, timeout=timeout)
    return _finish(out.stdout, out.stderr, out.returncode)


def pbrl_tpu_elbow():
    """pbrl_tpu's section 3 (``examples/quickstart.py``), the right elbow's
    qpos after 500 and after 1500 substeps."""
    import jax
    import jax.numpy as jnp

    from pbrl_tpu.control import (constant_trajectories, cubic_coefficients, default_gains,
                                  evaluate, implicit_pd, set_trajectories)
    from pbrl_tpu.engine import make_data
    from pbrl_tpu.engine.forward import step as engine_step
    from pbrl_tpu.model import humanoid_model

    nog = humanoid_model(gravity=False, floor=False)
    table = constant_trajectories(nog.nu, 0.0, t0=1.0, tf=3.0)
    idx = [nog.actuator_names.index(n) for n in ("right_elbow", "left_elbow")]
    table = set_trajectories(table, idx,
                             jnp.stack([cubic_coefficients(1.0, 3.0, 0.0, 1.5)] * 2))
    gains = default_gains()
    q = nog.jnt_qposadr[nog.joint_id("right_elbow")]

    def roll(d):
        def body(d, _):
            t_next = jnp.clip(d.time + nog.option.timestep, 1.0, 3.0)
            d = engine_step(nog, d, qfrc_fn=lambda mm, dd: implicit_pd(
                mm, dd, evaluate(table, t_next), gains))
            return d, d.qpos[q]
        return jax.lax.scan(body, d, None, length=1500)[1]

    ys = jax.jit(roll)(make_data(nog).replace(time=jnp.asarray(1.0)))
    return float(ys[499]), float(ys[-1])


def test_tour_physics_matches_pbrl_tpu():
    import jax

    from pbrl_tpu.engine import make_data, step_n
    from pbrl_tpu.model import sphere_model

    proc = subprocess.Popen(**_tour_cmd("--sections", "1,2,3"), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        m = sphere_model()
        want_z = float(jax.jit(lambda d: step_n(m, d, 500))(make_data(m)).qpos[2])
        want_mid, want_end = pbrl_tpu_elbow()
        text = _finish(*proc.communicate(timeout=120), proc.returncode)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    z = float(re.search(r"after 1 s: z = (\S+)", text).group(1))
    assert abs(z - want_z) < 1e-6, (z, want_z)
    assert re.search(r"replayed walk: 76 frames, root advanced 1\.22 m", text), text
    mid = float(re.search(r"right elbow at t = 2 s \(cubic 0\.75 rad\): (\S+) rad",
                          text).group(1))
    end = float(re.search(r"right elbow after tracking 1\.5 rad cubic: (\S+) rad",
                          text).group(1))
    assert abs(mid - want_mid) < 1e-5, (mid, want_mid)
    assert abs(end - want_end) < 1e-5, (end, want_end)
    assert "=== 4." not in text and "=== 5." not in text
