"""APG of the port on the humanoid, and ``cli train-apg``.

* The action gradient of one step's reward through ``MimicVecEnv`` on the
  engine (``backend="xla"``; 64 envs, 2 substeps, seeded reset states, the
  walk run's env config and backflip's) is finite, and its directional
  derivatives along 4 seeded directions (unit norm per env) equal central
  differences at eps 1e-2 within 10%: per env, in norm over the 64 envs,
  and, for walk, summed over them. (Backflip's per-env derivatives cancel
  in the sum, down to about a tenth of the largest one, where the f32
  physics' rounding in the difference is about as large; measured
  per-env errors 4-7% between eps 3e-3 and 3e-2.) Before
  ``angle_between`` had its own backward this gradient was NaN.
* The step is differentiable with held-torque PD, standard and
  inverse-dynamics PD, torque actions and the link observation (8 envs):
  a finite, non-zero action gradient of the reward and the next obs.
* One APG iteration on the humanoid with the critic's tail (2 envs,
  horizon 2): finite loss and ``grad_norm``, the policy moved, the critic
  bit-frozen.
* ``cli train-apg --device cpu`` at a tiny size (4 envs, horizon 2, hidden
  32,32, ``policy_dt=0.004``) from a ``cli train`` checkpoint: it inherits
  the source run's env config and widths, writes ``run_config.json``,
  ``apg_config.json`` and checkpoints that ``cli eval`` reads, and resumes
  with continued numbering; unknown ``--apg-set`` and ``--env-set`` fields
  are refused, and without a card it stops unless ``--device cpu``.
* ``slow`` (``--runslow`` only): the port's reward gradient against
  pbrl_tpu's jitted ``jax.grad`` on the inputs of pbrl_tpu's
  ``test_reward_grad_wrt_action_finite_nonzero`` (2 envs,
  ``policy_dt=0.004``, zero action), at 1e-3 relative to the gradient's
  largest entry (measured 1.1e-4, 8.6e-5 in norm: contacts amplify the
  two engines' f32 rounding, which agree to 1e-7 relative per stage). It
  takes about 200 s on the CPU, nearly all of it pbrl_tpu's compile (70 s
  with its compile cache warm).

No test here waits on pbrl_tpu's humanoid gradient except the slow one:
its XLA compile takes about 8 minutes on the CPU.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pbrl_tpu_torch import cli
from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
from pbrl_tpu_torch.mocap import load_clip
from pbrl_tpu_torch.model import humanoid_model
from pbrl_tpu_torch.train import apg, checkpoint
from pbrl_tpu_torch.utils.configio import dict_to_config

TINY = ["--device", "cpu", "--num-envs", "4"]


def _env(clip):
    """The env on the engine at ``policy_dt`` 0.004 (2 substeps): walk at the
    default config, another clip at its run's training config."""
    if clip == "walk":
        cfg = EnvConfig()
    else:
        _, _, run = checkpoint.load_policy(checkpoint.bundled_policy(clip), device="cpu")
        cfg = dict_to_config(EnvConfig, run["env_config"])
    cfg = dataclasses.replace(cfg, policy_dt=0.004, physics_dt=0.002)
    return MimicVecEnv(humanoid_model(), load_clip(clip, device="cpu"), cfg, backend="xla",
                       device="cpu")


@pytest.mark.parametrize("clip", ["walk", "backflip"])
def test_reward_grad_matches_central_difference(clip):
    env = _env(clip)
    B = 64
    s = env.reset(B, torch.Generator().manual_seed(0))
    a0 = torch.zeros(B, env.action_size)
    a = a0.clone().requires_grad_(True)
    env.step(s, a).reward.sum().backward()
    g = a.grad
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    gen = torch.Generator().manual_seed(1)
    eps = 1e-2
    with torch.no_grad():
        for _ in range(4):
            v = torch.randn(B, env.action_size, generator=gen)
            v = v / v.norm(dim=1, keepdim=True)
            fd = ((env.step(s, a0 + eps * v).reward.double()
                   - env.step(s, a0 - eps * v).reward.double()) / (2 * eps))
            dd = torch.sum(g * v, dim=1).double()
            rel = float((dd - fd).norm() / fd.norm())
            assert rel <= 0.1, (clip, rel)
            if clip == "walk":
                assert abs(float(dd.sum() - fd.sum())) <= 0.1 * abs(float(fd.sum()))


@pytest.mark.parametrize("kw", [
    {"pd_per_substep": False}, {"controller": "standard_pd"},
    {"controller": "inverse_dynamics_pd"}, {"action_mode": "torque"},
    {"include_link_obs": True}], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_step_is_differentiable_in_every_mode(kw):
    """Held-torque PD, the other controllers, torque actions and the link
    observation: autograd runs through each (no in-place op it refuses),
    and the action gradient of the reward and the next observation is
    finite and not zero."""
    env = MimicVecEnv(humanoid_model(), load_clip("walk", device="cpu"),
                      EnvConfig(policy_dt=0.004, **kw), backend="xla", device="cpu")
    s = env.reset(8, torch.Generator().manual_seed(0))
    a = torch.zeros(8, env.action_size, requires_grad=True)
    ns = env.step(s, a)
    (ns.reward.sum() + ns.obs.sum()).backward()
    assert bool(torch.isfinite(a.grad).all()) and float(a.grad.abs().max()) > 0


def test_apg_iteration_on_the_humanoid():
    env = _env("walk")
    cfg = apg.APGConfig(num_envs=2, horizon=2, hidden=(16,), action_noise=0.05,
                        total_env_steps=4)
    ts = apg.init(env, cfg, "cpu")
    before = {k: v.clone() for k, v in ts.policy.state_dict().items()}
    frozen = {k: v.clone() for k, v in ts.value.state_dict().items()}
    ts, metrics = apg.train_step(env, cfg, ts)
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0
    assert any(not torch.equal(v, before[k]) for k, v in ts.policy.state_dict().items())
    assert all(torch.equal(v, frozen[k]) for k, v in ts.value.state_dict().items())


def _lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]


def test_cli_train_apg_writes_resumes_and_evaluates(tmp_path, capsys):
    src, dst = str(tmp_path / "ppo"), str(tmp_path / "apg")
    assert cli.main(["train", *TINY, "--unroll-length", "4", "--total-steps", "32",
                     "--train-set", "hidden=32,32", "--env-set", "policy_dt=0.004",
                     "--checkpoint-dir", src, "--quiet"]) == 0
    capsys.readouterr()
    argv = ["train-apg", *TINY, "--horizon", "2", "--total-steps", "16", "--steps-per-call", "1",
            "--from-checkpoint", src, "--checkpoint-dir", dst,
            "--apg-set", "action_noise=0.1", "--apg-set", "reset_every=1"]
    assert cli.main(argv) == 0
    lines = _lines(capsys)
    assert [x["iteration"] for x in lines[:-1]] == [0, 1]
    final = lines[-1]["final"]
    assert final["env_steps"] == 16
    for k in ("loss", "grad_norm", "reward_mean", "window_alive_frac", "forward_s",
              "backward_s", "sps"):
        assert np.isfinite(final[k]), k
    run, source = checkpoint.load_run_config(dst), checkpoint.load_run_config(src)
    assert run["clip"] == "walk" and run["env_config"] == source["env_config"]
    assert run["env_config"]["policy_dt"] == 0.004
    assert run["train_config"]["hidden"] == [32, 32]
    with open(os.path.join(dst, "apg_config.json")) as f:
        cfg = json.load(f)
    assert cfg["action_noise"] == 0.1 and cfg["reset_every"] == 1 and cfg["hidden"] == [32, 32]
    assert checkpoint._steps(dst) == [2]
    first = checkpoint.restore(dst)
    assert first["env_steps"] == checkpoint.restore(src)["env_steps"] + 16
    for k, v in checkpoint.restore(src)["value"].items():
        assert torch.equal(first["value"][k], v), k

    assert cli.main([*argv, "--quiet"]) == 0
    assert checkpoint.latest_step(dst) == 4  # continued from 2
    assert checkpoint.restore(dst)["env_steps"] == first["env_steps"] + 16
    capsys.readouterr()
    assert cli.main(["eval", "--device", "cpu", "--checkpoint-dir", dst, "--num-envs", "2",
                     "--steps", "1"]) == 0
    out = _lines(capsys)[-1]
    assert out["eval_episode_length"] == 1.0 and all(np.isfinite(v) for v in out.values())


@pytest.mark.parametrize("flag", ["--apg-set", "--env-set"])
def test_cli_train_apg_refuses_unknown_fields(flag, tmp_path):
    with pytest.raises(SystemExit, match=f"{flag}: unknown"):
        cli.main(["train-apg", *TINY, flag, "no_such_field=1", "--checkpoint-dir",
                  str(tmp_path)])
    assert not os.path.exists(tmp_path / "run_config.json")


def test_cli_train_apg_without_card_does_not_fall_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(SystemExit, match="no CUDA device.*--device cpu"):
        cli.main(["train-apg", "--num-envs", "4", "--checkpoint-dir", str(tmp_path)])
    assert not os.path.exists(tmp_path / "run_config.json")


def test_apg_refuses_the_kernel_backend():
    env = MimicVecEnv(humanoid_model(), load_clip("walk", device="cpu"),
                      EnvConfig(policy_dt=0.004), device="cpu")
    assert env.backend == "kernel"
    with pytest.raises(ValueError, match="backend='xla'"):
        apg.init(env, apg.APGConfig(num_envs=2, horizon=1, hidden=(8,)), "cpu")


@pytest.mark.slow
def test_reward_grad_matches_pbrl_tpu():
    import time

    import jax
    import jax.numpy as jnp

    from pbrl_tpu.envs import EnvConfig as JEnvConfig
    from pbrl_tpu.envs import MimicVecEnv as JMimicVecEnv
    from pbrl_tpu.mocap import load_clip as jload_clip
    from pbrl_tpu.model import humanoid_model as jhumanoid
    from pbrl_tpu_torch.envs import VecState

    t0 = time.perf_counter()
    jenv = JMimicVecEnv(jhumanoid(), jload_clip("walk"),
                        JEnvConfig(policy_dt=0.004, physics_dt=0.002), backend="xla")
    vs = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), 2))
    want = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(jenv.step(vs, a).reward)))(
        jnp.zeros((2, jenv.action_size))))
    t_jax = time.perf_counter() - t0

    env = _env("walk")
    s = VecState(**{k: torch.from_numpy(np.array(getattr(vs, k)))
                    for k in ("qpos", "qvel", "time", "episode_start", "obs", "reward", "done")},
                 metrics={k: torch.from_numpy(np.array(v)) for k, v in vs.metrics.items()})
    a = torch.zeros(2, env.action_size, requires_grad=True)
    torch.sum(env.step(s, a).reward).backward()
    got = a.grad.numpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"pbrl_tpu grad in {t_jax:.1f}s; max |port - pbrl_tpu| / max |pbrl_tpu| = {err:.3e}, "
          f"in norm {rel:.3e}")
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert err < 1e-3
