"""pbrl_tpu_torch and chip_smoke.py import without JAX and without pbrl_tpu.

A subprocess sets ``jax``, ``jaxlib``, ``flax``, ``optax``, ``orbax``,
``mujoco`` and ``pbrl_tpu`` to None in ``sys.modules`` (so any import of
them raises) and then imports every module of the port and runs
chip_smoke.py's imports.
"""

import os
import pkgutil
import subprocess
import sys

import pbrl_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "mujoco", "pbrl_tpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(pbrl_tpu_torch.__path__,
                                                        "pbrl_tpu_torch."))


def test_every_module_listed():
    mods = _modules()
    for want in ("pbrl_tpu_torch.ops.mimic_kernel", "pbrl_tpu_torch.envs.vec",
                 "pbrl_tpu_torch.train.ppo", "pbrl_tpu_torch.cli",
                 "pbrl_tpu_torch.train.optim", "pbrl_tpu_torch.train.checkpoint",
                 "pbrl_tpu_torch.train.networks", "pbrl_tpu_torch.train.running_stats",
                 "pbrl_tpu_torch.utils.configio", "pbrl_tpu_torch.maths.quaternion",
                 "pbrl_tpu_torch.maths.spatial", "pbrl_tpu_torch.ops.linalg",
                 "pbrl_tpu_torch.engine.data", "pbrl_tpu_torch.engine.kinematics",
                 "pbrl_tpu_torch.engine.collision", "pbrl_tpu_torch.engine.dynamics",
                 "pbrl_tpu_torch.engine.solver", "pbrl_tpu_torch.engine.forward",
                 "pbrl_tpu_torch.control.pd", "pbrl_tpu_torch.control.trajectory",
                 "pbrl_tpu_torch.envs.humanoid_task", "pbrl_tpu_torch.envs.base",
                 "pbrl_tpu_torch.envs.replay", "pbrl_tpu_torch.envs.mimic",
                 "pbrl_tpu_torch.viz.render"):
        assert want in mods


def test_port_imports_with_jax_blocked():
    code = "\n".join([
        "import sys",
        *[f"sys.modules[{m!r}] = None" for m in BLOCKED],
        "import importlib",
        *[f"importlib.import_module({m!r})" for m in _modules()],
        "import ast",
        "src = open('chip_smoke.py').read()",
        "mods = set()",
        "for node in ast.walk(ast.parse(src)):",
        "    if isinstance(node, ast.Import):",
        "        mods.update(a.name for a in node.names)",
        "    elif isinstance(node, ast.ImportFrom):",
        "        mods.add(node.module)",
        "assert not {m.split('.')[0] for m in mods} & set(" + repr(BLOCKED) + "), mods",
        "for m in sorted(mods):",
        "    importlib.import_module(m)",
        "import chip_smoke",
        "print('ok', len(mods))",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")
