"""End-to-end tour of the PyTorch port (``pbrl_tpu_torch``): the five
sections of ``examples/quickstart.py`` on the port.

1. the sphere drop through ``engine.step_n``;
2. kinematic replay of a DeepMimic clip (``ReplayEnv.rollout``);
3. Stable-PD tracking of cubic elbow trajectories
   (``control/trajectory.py``, implicit PD through the engine);
4. 256 envs of ``MimicVecEnv`` stepped once (one launch of the policy-step
   kernel on the card; its plain version on the CPU);
5. a short PPO burst through ``make_train_functions``.

Run on the card (the default), or on the CPU at small sizes:

    python examples/quickstart_torch.py [--train-steps 200000]
    python examples/quickstart_torch.py --device cpu --num-envs 2 --train-steps 16
    python examples/quickstart_torch.py --sections 1,3     # some sections only
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def section(title):
    print(f"\n=== {title} " + "=" * max(0, 60 - len(title)), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train-steps", type=int, default=200_000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--num-envs", type=int, default=256, help="envs of sections 4 and 5")
    ap.add_argument("--sections", default="1,2,3,4,5",
                    help="the sections to run, comma-separated (5 needs 4)")
    args = ap.parse_args(argv)
    run = {int(x) for x in args.sections.split(",") if x}
    if not run <= {1, 2, 3, 4, 5} or (5 in run and 4 not in run):
        raise SystemExit(f"--sections {args.sections}: sections 1-5, and 5 needs 4")

    import torch

    from pbrl_tpu_torch.cli import _require_device

    _require_device(args.device)
    dev = torch.device(args.device)
    with torch.no_grad():  # sections 1-4 take no gradient
        for k, fn in ((1, sphere_section), (2, replay_section), (3, pd_section)):
            if k in run:
                fn(dev)
        venv = env_section(dev, args.num_envs) if 4 in run else None
    if 5 in run:
        train_section(dev, venv, args)
    return 0


def sphere_section(dev):
    from pbrl_tpu_torch.engine import make_data, step_n
    from pbrl_tpu_torch.model import sphere_model

    section("1. Raw physics: sphere drop (the reference's sanity scene)")
    m = sphere_model()
    d = step_n(m, make_data(m, device=dev), 500)
    print(f"after 1 s: z = {float(d.qpos[0, 2]):.7f} (rests near its radius 0.1)")


def replay_section(dev):
    from pbrl_tpu_torch.envs import ReplayEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model

    section("2. Kinematic replay of a DeepMimic clip (testing_forward_env)")
    clip = load_clip("walk", device=dev)
    states = ReplayEnv(humanoid_model(), clip).rollout(76)  # one cycle at 60 fps
    x = states.pipeline.qpos[:, 0, 0]
    print(f"replayed {clip.name}: {states.obs.shape[0]} frames, "
          f"root advanced {float(x[-1] - x[0]):.2f} m")


def pd_section(dev):
    import torch

    from pbrl_tpu_torch.engine import make_data
    from pbrl_tpu_torch.model import humanoid_model

    section("3. Stable-PD tracking of cubic joint trajectories (testing_pds_env)")
    from pbrl_tpu_torch.control import (constant_trajectories, cubic_coefficients,
                                        default_gains, evaluate, implicit_pd,
                                        set_trajectories)
    from pbrl_tpu_torch.engine.forward import step as engine_step
    from pbrl_tpu_torch.envs.humanoid_task import gains_on

    nog = humanoid_model(gravity=False, floor=False)
    table = constant_trajectories(nog.nu, 0.0, t0=1.0, tf=3.0)
    idx = [nog.actuator_names.index(n) for n in ("right_elbow", "left_elbow")]
    table = set_trajectories(table, idx,
                             torch.stack([cubic_coefficients(1.0, 3.0, 0.0, 1.5)] * 2)).to(dev)
    gains = gains_on(default_gains(), dev)
    d = make_data(nog, device=dev).replace(time=torch.ones(1, device=dev))
    elbow = nog.jnt_qposadr[nog.joint_id("right_elbow")]
    for i in range(1500):
        target = evaluate(table, torch.clamp(d.time + float(nog.option.timestep), 1.0, 3.0)[:, None])
        d = engine_step(nog, d, qfrc_fn=lambda mm, dd, target=target: implicit_pd(
            mm, dd, target, gains))
        if i == 499:  # t = 2 s, the cubic's midpoint
            print(f"right elbow at t = 2 s (cubic 0.75 rad): {float(d.qpos[0, elbow]):.6f} rad")
    print(f"right elbow after tracking 1.5 rad cubic: {float(d.qpos[0, elbow]):.6f} rad")


def env_section(dev, num_envs):
    """Section 4; returns its env."""
    import torch

    from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model

    section("4. Batched imitation env over the policy-step kernel")
    venv = MimicVecEnv(humanoid_model(), load_clip("walk", device=dev), EnvConfig(), device=dev)
    kind = "the CUDA kernel" if dev.type == "cuda" else "its plain version on the CPU"
    print(f"backend: {venv.backend} ({kind})")
    gen = torch.Generator(device=dev).manual_seed(0)
    vs = venv.reset(num_envs, gen)
    vs = venv.step(vs, torch.zeros(num_envs, venv.action_size, device=dev))
    print(f"{num_envs} envs stepped; mean reward {float(vs.reward.mean()):.3f}")
    return venv


def train_section(dev, venv, args):
    import torch

    section("5. A short PPO burst")
    from pbrl_tpu_torch.train import TrainConfig, make_train_functions

    cfg = TrainConfig(num_envs=args.num_envs, unroll_length=8, num_minibatches=4,
                      update_epochs=2, total_env_steps=args.train_steps)
    init, train_step, evaluate_policy = make_train_functions(venv, cfg)
    ts = init(dev)
    first = last = None
    t = time.perf_counter()
    for _ in range(cfg.num_iterations):
        ts, metrics = train_step(ts)
        last = float(metrics["reward_mean"])
        first = last if first is None else first
    sps = ts.env_steps / (time.perf_counter() - t)
    print(f"{ts.env_steps} env steps: reward {first:.3f} -> {last:.3f} at {sps:.0f} steps/s")
    ev = evaluate_policy(ts.policy, ts.obs_stats, num_envs=args.num_envs, num_steps=4,
                         generator=torch.Generator(device=dev).manual_seed(1))
    print(f"eval over 4 steps: reward {float(ev['eval_reward']):.3f}, "
          f"length {float(ev['eval_episode_length']):.2f}")


if __name__ == "__main__":
    sys.exit(main())
