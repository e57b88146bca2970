"""Data parallelism of the port (``pbrl_tpu_torch.parallel``) against
pbrl_tpu's.

The process-group entry points run in a subprocess, as
tests/test_distributed.py runs pbrl_tpu's. The multi-rank checks start 2
ranks of tests/torch_dp_worker.py on the CPU (gloo, a free port, a
timeout on the group and on each process) and hold what they compute
against one process of the port and against pbrl_tpu: the running
statistics against pbrl_tpu's ``update`` of the whole batch, one PPO train
step against pbrl_tpu's step sharded over the 8-virtual-device mesh (as
tests/test_ppo.py::test_train_step_sharded_over_mesh runs it), and APG's
train step against pbrl_tpu's, with pbrl_tpu's draws fed in. The two
ranks' parameters must be bit-equal.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrl_tpu.parallel import make_mesh as j_make_mesh
from pbrl_tpu.parallel import replicated, sharded_batch_spec
from pbrl_tpu.train import apg as japg
from pbrl_tpu.train import running_stats as jrs
from pbrl_tpu_torch.parallel import Mesh, distributed, shard_batch
from pbrl_tpu_torch.train import apg, ppo, running_stats
from pbrl_tpu_torch.train.checkpoint import flax_state_dict
from test_torch_apg import JDrivenEnv
from test_torch_ppo import _jax_draws, _jax_functions, _tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dp_worker.py")
TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(job, inputs, meta, tmp_path, world=2):
    """Run ``job`` on ``world`` worker ranks; their outputs, by rank."""
    path = str(tmp_path / f"{job}_inputs.npz")
    np.savez(path, meta=json.dumps(meta), **inputs)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, WORKER, job, str(r), str(world), str(port), path,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    outs = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


# ---------------------------------------------------------------------------
# Process group, mesh, flags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["explicit", "torchrun_env"])
def test_single_process_initialize_and_guards(how):
    """tests/test_distributed.py's checks on the port: initialise, the
    guards, idempotent re-entry, shutdown; from explicit flags and from
    torchrun's environment."""
    port = free_port()
    cfg = (f"DistributedConfig(coordinator_address='localhost:{port}', num_processes=1, "
           "process_id=0)" if how == "explicit" else "DistributedConfig()")
    code = textwrap.dedent(f"""
        from pbrl_tpu_torch.parallel import DistributedConfig, initialize_distributed
        from pbrl_tpu_torch.parallel import is_primary_host, make_mesh
        from pbrl_tpu_torch.parallel.distributed import (
            backend, is_initialized, process_count, shutdown)

        assert is_primary_host() and process_count() == 1 and backend() is None
        cfg = {cfg}
        assert initialize_distributed(cfg, device="cpu") is True
        assert is_initialized()
        assert process_count() == 1
        assert is_primary_host()
        assert backend() == "gloo"
        mesh = make_mesh("cpu")
        assert (mesh.world, mesh.rank, mesh.device.type) == (1, 0, "cpu")
        assert initialize_distributed(cfg, device="cpu") is False  # a no-op, not an error
        shutdown()
        assert not is_initialized()
        print("DIST_OK")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    if how == "torchrun_env":
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0",
                   LOCAL_RANK="0")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "DIST_OK" in proc.stdout


def test_primary_host_without_initialization():
    assert distributed.is_primary_host()
    assert distributed.process_count() == 1


def test_cli_exposes_distributed_flags():
    from pbrl_tpu_torch.cli import build_parser

    args = build_parser().parse_args([
        "train", "--distributed", "--coordinator", "localhost:1234",
        "--num-processes", "2", "--process-id", "1"])
    assert args.distributed and args.coordinator == "localhost:1234"
    assert args.num_processes == 2 and args.process_id == 1
    assert not build_parser().parse_args(["train"]).distributed


def test_backend_rule(monkeypatch):
    """NCCL when each process of the host has a card, gloo when processes
    share one or run on the CPU."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert distributed.backend_for("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.backend_for("cuda", 2) == "gloo"
    assert distributed.backend_for("cuda", 1) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.backend_for("cuda", 4) == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")  # two hosts of 8 processes, 4 cards each
    assert distributed.backend_for("cuda", 16) == "gloo"


def test_mesh_rows_and_shard_batch():
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(Mesh().rows(x), x)
    m = Mesh(world=3, rank=1)
    assert torch.equal(m.rows(x), x[2:4])
    assert torch.equal(m.rows(x.t(), dim=1), x[2:4].t())
    tree = ppo.Transition(obs=x, action=x[:, :1], log_prob=x[:, 0], reward=x[:, 1],
                          done=x[:, 0], value=x[:, 1])
    got = shard_batch(m, {"t": tree, "n": 3})
    assert got["n"] == 3 and torch.equal(got["t"].action, x[2:4, :1])
    with pytest.raises(ValueError, match="not divisible"):
        m.rows(torch.zeros(4))


def test_num_envs_not_divisible_raises():
    from test_torch_ppo import ToyEnv

    env = ToyEnv()
    env.mesh = Mesh(world=2)
    _, cfg = _tiny_config(num_envs=15)
    with pytest.raises(ValueError, match="not divisible by 2"):
        ppo.init(env, cfg, device="cpu")
    with pytest.raises(ValueError, match="not divisible by 2"):
        apg.init(env, apg.APGConfig(num_envs=15, hidden=(4,)), device="cpu")


def test_env_reset_takes_its_rows_of_the_whole_batch():
    """Each rank's reset draws the whole batch's RSI times and noise from
    the shared seed and keeps its rows: the ranks' resets stack into one
    process's (no collective needed)."""
    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model

    model, clip = humanoid_model(), load_clip("walk", device="cpu")
    cfg = EnvConfig(rsi_noise_qpos=0.05, rsi_noise_qvel=0.5, rsi_noise_root_xy=0.1,
                    rsi_phase_bias=0.5)
    whole = MimicVecEnv(model, clip, cfg, device="cpu").reset(6, torch.Generator().manual_seed(3))
    parts = [MimicVecEnv(model, clip, cfg, device="cpu", mesh=Mesh(world=3, rank=r))
             .reset(6, torch.Generator().manual_seed(3)) for r in range(3)]
    for k in ("qpos", "qvel", "time", "obs"):
        assert torch.equal(torch.cat([getattr(p, k) for p in parts]), getattr(whole, k)), k


# ---------------------------------------------------------------------------
# Two ranks against one process and against pbrl_tpu
# ---------------------------------------------------------------------------


def test_running_stats_two_ranks(tmp_path):
    """2 ranks' ``update`` of their halves against the port's 1 rank and
    pbrl_tpu's ``update`` of the whole batch, at 1e-6."""
    batch = np.random.default_rng(7).normal(2.0, 3.0, size=(8, 5, 6)).astype(np.float32)
    outs = run_ranks("stats", {"batch": batch}, {}, tmp_path)
    one = running_stats.update(running_stats.init(6, "cpu"), torch.from_numpy(batch))
    want = jrs.update(jrs.init(6), jnp.asarray(batch))
    for k in ("count", "mean", "m2"):
        for out in outs:
            np.testing.assert_allclose(out[k], getattr(one, k).numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(out[k], np.asarray(getattr(want, k)), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    assert float(outs[0]["count"]) == 40.0


def _state_dict_inputs(params):
    return {f"{name}.{k}": v.numpy() for name in ("policy", "value")
            for k, v in flax_state_dict(jax.tree_util.tree_map(np.asarray, params[name])).items()}


def _assert_ranks_match(outs, i, jts, jmetrics, metric_tol):
    want_params = _state_dict_inputs(jts.params)
    for k in jmetrics:
        for out in outs:
            np.testing.assert_allclose(float(out[f"it{i}/metric.{k}"]), float(jmetrics[k]),
                                       err_msg=f"iteration {i} {k}", **metric_tol)
        assert outs[0][f"it{i}/metric.{k}"] == outs[1][f"it{i}/metric.{k}"], k
    for k, want in want_params.items():
        np.testing.assert_allclose(outs[0][f"it{i}/{k}"], want, atol=1e-6, rtol=0,
                                   err_msg=f"iteration {i} {k}")
        np.testing.assert_array_equal(outs[0][f"it{i}/{k}"], outs[1][f"it{i}/{k}"], err_msg=k)
    for k in ("count", "mean", "m2"):
        np.testing.assert_allclose(outs[0][f"it{i}/stats.{k}"],
                                   np.asarray(getattr(jts.obs_stats, k)), rtol=1e-5, err_msg=k)
        np.testing.assert_array_equal(outs[0][f"it{i}/stats.{k}"], outs[1][f"it{i}/stats.{k}"])
    np.testing.assert_allclose(np.concatenate([o[f"it{i}/obs"] for o in outs]),
                               np.asarray(jts.env_state.obs), atol=1e-6)


def test_ppo_train_step_two_ranks_matches_sharded_pbrl_tpu(tmp_path):
    """Two PPO iterations at 2 ranks (8 envs each) with pbrl_tpu's draws
    fed in, against pbrl_tpu's train step with the env batch sharded over
    the 8-device mesh, at test_train_step_matches_pbrl_tpu's tolerances
    (metrics rtol 2e-5 / atol 1e-6, params atol 1e-6); both ranks' metrics,
    params and obs stats bit-equal."""
    assert jax.device_count() >= 8, "conftest should provide 8 virtual devices"
    jcfg, cfg = _tiny_config(num_minibatches=4, entropy_cost=1e-2, total_env_steps=16 * 8 * 2)
    init, step, _ = _jax_functions(jcfg)
    jts = init(jax.random.PRNGKey(0))
    inputs = _state_dict_inputs(jts.params)
    mesh = j_make_mesh()
    sh = jax.tree.map(lambda _: replicated(mesh), jts)
    sh = sh.replace(env_state=jax.tree.map(lambda _: sharded_batch_spec(mesh), jts.env_state))
    jts = jax.device_put(jts, sh)
    step = jax.jit(step, in_shardings=(sh,), out_shardings=(sh, replicated(mesh)))
    history = []
    for i in range(2):
        noise, perms = _jax_draws(jts.rng, jcfg)
        inputs[f"noise{i}"], inputs[f"perms{i}"] = noise.numpy(), perms.numpy()
        jts, jmetrics = step(jts)
        assert len(jts.env_state.obs.sharding.device_set) == 8
        history.append((jax.device_get(jts), jax.device_get(jmetrics)))
    meta = {"config": {f: getattr(cfg, f) for f in ("num_envs", "unroll_length",
                                                      "num_minibatches", "update_epochs",
                                                      "hidden", "learning_rate", "entropy_cost",
                                                      "total_env_steps", "seed")},
            "iterations": 2}
    outs = run_ranks("ppo", inputs, meta, tmp_path)
    for i, (jts_i, jmetrics) in enumerate(history):
        _assert_ranks_match(outs, i, jts_i, jmetrics, dict(rtol=2e-5, atol=1e-6))
    for out in outs:
        assert int(out["env_steps"]) == 2 * cfg.steps_per_iteration
        assert int(out["opt_count"]) == 2 * cfg.update_epochs * cfg.num_minibatches


def test_apg_train_step_two_ranks_matches_pbrl_tpu(tmp_path):
    """Two APG iterations at 2 ranks against pbrl_tpu's train step (the
    window's noise, reset_every=1, obs stats updated), pbrl_tpu's draws fed
    in: metrics rtol 2e-5 / atol 1e-6, the policy at 1e-6; the ranks
    bit-equal."""
    from test_torch_apg import _noise

    kw = dict(num_envs=16, horizon=8, hidden=(32, 32), learning_rate=3e-3, gamma=0.9,
              total_env_steps=16 * 8 * 2, seed=0, action_noise=0.1, reset_every=1,
              update_obs_stats=True, value_bootstrap=True)
    jcfg, cfg = japg.APGConfig(**kw), apg.APGConfig(**kw)
    init, step, _ = japg.make_apg_functions(JDrivenEnv(), jcfg)
    jts = init(jax.random.PRNGKey(0))
    inputs = _state_dict_inputs(jts.params)
    step = jax.jit(step)
    history = []
    for i in range(2):
        inputs[f"noise{i}"] = _noise(jts.rng, jcfg).numpy()
        jts, jmetrics = step(jts)
        history.append((jts, jmetrics))
    outs = run_ranks("apg", inputs, {"config": kw, "iterations": 2}, tmp_path)
    for i, (jts_i, jmetrics) in enumerate(history):
        _assert_ranks_match(outs, i, jts_i, jmetrics, dict(rtol=2e-5, atol=1e-6))
        np.testing.assert_array_equal(np.concatenate([o[f"it{i}/time"] for o in outs]),
                                      np.asarray(jts_i.env_state.t))
    for out in outs:
        assert int(out["env_steps"]) == 2 * cfg.steps_per_iteration and int(out["opt_count"]) == 2


def test_curriculum_auto_reset_two_ranks(tmp_path):
    """The curriculum's peers come from every rank: 2 ranks' auto-resets
    of their halves, given the whole batch's draws, stack into one
    process's auto-reset of the whole batch."""
    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model

    env_cfg = dict(curriculum_reset_prob=0.7, curriculum_recenter_xy=True)
    env = MimicVecEnv(humanoid_model(), load_clip("walk", device="cpu"), EnvConfig(**env_cfg),
                      device="cpu")
    B = 8
    s = env.reset(B, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(8)
    done = np.array([1, 0, 0, 1, 1, 0, 1, 0], np.float32)
    s = s.replace(time=s.time + 0.3, done=torch.from_numpy(done),
                  reward=torch.from_numpy(rng.uniform(size=B).astype(np.float32)))
    t0 = torch.from_numpy(rng.uniform(0, 1, B).astype(np.float32))
    # done envs 0, 3, 4, 6 take their peers where u < 0.7: 0 <- 1, 3 <- 7 and
    # 6 <- 7 from rank 1's envs 4-7, 4 <- 2 from rank 0's
    u = torch.tensor([0.1, 0.9, 0.2, 0.3, 0.2, 0.5, 0.1, 0.8])
    peer = torch.tensor([1, 2, 5, 7, 2, 1, 7, 5])
    want = env.auto_reset(s, t0=t0, u=u, peer=peer)
    fields = ("qpos", "qvel", "time", "episode_start", "obs", "reward", "done")
    inputs = {k: getattr(s, k).numpy() for k in fields}
    inputs.update(t0=t0.numpy(), u=u.numpy(), peer=peer.numpy())
    outs = run_ranks("curriculum", inputs, {"env_config": env_cfg}, tmp_path)
    for k in fields:
        np.testing.assert_array_equal(np.concatenate([o[k] for o in outs]),
                                      getattr(want, k).numpy(), err_msg=k)
    for env_i, peer_i in ((0, 1), (3, 7), (4, 2), (6, 7)):
        assert torch.equal(want.time[env_i], s.time[peer_i])
        assert torch.equal(want.qvel[env_i], s.qvel[peer_i])
