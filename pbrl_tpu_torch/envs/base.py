"""Environment protocol, configuration, states and registry.

Counterpart of ``pbrl_tpu/envs/base.py``: ``EnvConfig`` keeps the same
fields and defaults (the defaults are the main path: 60 Hz policy over
500 Hz physics, implicit PD re-solved every substep, 'step' self-contact
mass, absolute PD targets, torque scale 2.0). ``State`` is the state of the
per-env environments (``ReplayEnv``, ``MimicEnv``) with engine ``Data``
inside; ``VecState`` is the lean state of
:class:`~pbrl_tpu_torch.envs.vec.MimicVecEnv`. pbrl_tpu's states hold one
env and are batched by ``vmap``; these carry a leading env axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from pbrl_tpu_torch.engine.data import Data


@dataclasses.dataclass(frozen=True)
class State:
    """RL state of a batch of envs."""

    pipeline: Data                    # physics state and derived caches
    obs: torch.Tensor                 # (B, obs_dim)
    reward: torch.Tensor              # (B,)
    done: torch.Tensor                # (B,) 1.0 = episode over
    metrics: Dict[str, torch.Tensor]  # (B,) each, updated every step
    info: Dict[str, Any]              # episode bookkeeping

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Typed configuration replacing the reference's variant-by-file pattern.

    ``variant1`` = 60 Hz policy / 500 Hz physics (8 substeps,
    ``agent_env_template.py:60-68``); ``variant2`` = 30 Hz policy / 1200 Hz
    physics (40 substeps, ``agent_env_template2.py:49-58``).
    """

    policy_dt: float = 1.0 / 60.0
    physics_dt: float = 0.002
    # -- mimic reward weights & scales (DeepMimic) --
    w_pose: float = 0.65
    w_vel: float = 0.1
    w_ee: float = 0.15
    w_com: float = 0.1
    s_pose: float = 2.0
    s_vel: float = 0.1
    s_ee: float = 40.0
    s_com: float = 10.0
    # -- episode control --
    reference_state_init: bool = True   # RSI: reset at a random clip phase
    # RSI phase curriculum: 0 = uniform over the clip. Positive values bias
    # resets toward LATER phases (t0 = hi * u^(1/(1+bias))) — e.g. the
    # aerial/landing segment of ballistic clips; negative toward earlier
    # (t0 = hi * u^(1-bias)).
    rsi_phase_bias: float = 0.0
    # Gaussian noise added to RSI reset states (joint angles / all dof
    # velocities). Nonzero values teach a funnel back onto the reference
    # from slightly-off states — e.g. the state after a real backflip
    # landing, which never exactly matches the reference restart.
    rsi_noise_qpos: float = 0.0
    rsi_noise_qvel: float = 0.0
    # Uniform root-XY offset (± meters) added at reset. Joint/velocity
    # noise never displaces the root, so a policy only visits laterally-
    # drifted states late in an episode where the discounted gradient is
    # weak; starting some episodes already off-track (the offset is
    # observable through ``include_ref_root_offset``) trains ACTIVE drift
    # correction — steering back onto the reference track during stance —
    # instead of mere drift tolerance.
    rsi_noise_root_xy: float = 0.0
    early_termination: bool = True      # terminate on fall
    # Terminate when the root-orientation error vs the reference exceeds
    # this many radians (0 = off). Kills the "stand still through the
    # aerial phase" local optimum of ballistic clips: an episode that does
    # not rotate with the reference ends instead of farming ground-phase
    # reward.
    pose_termination: float = 0.0
    # Once an episode has survived one full clip cycle, switch to this
    # (larger) root-error threshold instead of ``pose_termination`` (0 =
    # unchanged). Lets the policy recover from an imperfect first landing
    # instead of dying at the cycle-2 takeoff
    # (docs/BACKFLIP_EXPERIMENTS.md idea 3).
    pose_termination_after_cycle: float = 0.0
    # -- aerial-phase reward shaping (ballistic clips) --
    # ``(phase_lo, phase_hi)`` flight window in [0, 1); empty = off. Inside
    # the window the reward is re-weighted toward root orientation +
    # root angular velocity: the mid-air tuck pose is only loosely
    # trackable and its gradient drowns out the rotation signal that
    # actually decides whether the flip lands
    # (docs/BACKFLIP_EXPERIMENTS.md idea 1).
    aerial_window: tuple = ()
    aerial_w_pose: float = 0.2
    aerial_w_root: float = 0.35
    aerial_w_angvel: float = 0.25
    aerial_w_com: float = 0.2
    aerial_s_root: float = 2.0          # exp(-s * root_rot_err^2)
    aerial_s_angvel: float = 0.02       # exp(-s * |root_angvel_err|^2)
    aerial_edge: float = 0.03           # smooth blend width (phase units)
    # -- drift shaping (training-only, stripped at eval like the aerial
    # window) --
    # The standard EE/COM exponentials (s_ee=40, s_com=10) saturate to ~0
    # once horizontal drift vs the reference exceeds ~15 cm, so their
    # gradient vanishes exactly where drift correction is needed
    # (docs/BACKFLIP_EXPERIMENTS.md arm M diagnosis: 0.2-0.3 m/cycle).
    # A gentle root-xy term exp(-s * |xy - ref_xy|^2) keeps the gradient
    # alive out to ~1 m; blended with weight w: r = (1-w)*r + w*r_drift.
    drift_w: float = 0.0                # 0 = off
    drift_s: float = 3.0
    # -- dynamics randomization (training-only; eval resets to 1.0) --
    # Scale the contact model the policy trains against. Alternating resume
    # rounds over a small set of scales (e.g. tc x{0.7, 1.0, 1.4}) is a
    # sequential approximation of per-env domain randomization: it stops
    # the policy overfitting one engine's landing behavior, which is what
    # the MuJoCo-transfer parity harness (scripts/reward_parity.py)
    # measures. contact_tc_scale multiplies option.contact_timeconst
    # (higher = softer ground); friction_scale multiplies geom_friction.
    contact_tc_scale: float = 1.0
    friction_scale: float = 1.0
    # Self-contact effective-mass model (round 4; both engines + kernel):
    # 'step' (default) = exact two-body Delassus mass solved at policy-step
    # entry and held across the step's substeps; 'substep' = exact every
    # physics substep; 'static' = round-2/3 harmonic surrogate.
    self_contact_mass: str = "step"
    # -- takeoff-state curriculum (MimicVecEnv only) --
    # On auto-reset, with this probability a finished env restarts from the
    # CURRENT state of a random alive peer env instead of from the
    # reference (state-distribution matching,
    # docs/BACKFLIP_EXPERIMENTS.md idea 2) — trains continuation from
    # policy-visited states (e.g. the post-landing crouch) that on-
    # reference RSI never samples.
    curriculum_reset_prob: float = 0.0
    # Optional ``(phase_lo, phase_hi)`` filter: only peers whose clip phase
    # is inside the window are adopted (e.g. the landing->takeoff segment).
    curriculum_phase_window: tuple = ()
    # Translate adopted states' root x/y onto the reference track at the
    # adopted time. The pose/velocity distribution is what the curriculum
    # is matching; inheriting the peer's ACCUMULATED drift just scales its
    # EE/COM reward toward zero and starves the continuation of gradient.
    curriculum_recenter_xy: bool = True
    fall_contact_bodies: tuple = ()     # body names allowed to touch ground
    max_episode_time: float = 10.0
    # -- observation --
    exclude_root_xy: bool = True        # translation-invariant obs
    include_phase: bool = True
    # Append the reference-relative root offset (ref_xy(t) - xy, rotated
    # into the root's heading frame; 2 dims). With exclude_root_xy the
    # policy is blind to accumulated horizontal drift vs the reference and
    # cannot correct it even in principle — measured 0.2-0.3 m/cycle on
    # backflip, costing ~0.15 reward through the EE/COM terms. This feature
    # restores observability while keeping the obs translation-invariant.
    include_ref_root_offset: bool = False
    # Append DeepMimic-style link-state features: per-body position
    # (root-relative, heading-frame) + orientation (heading-normalized
    # quaternion) — 7 * nbody dims. Joint angles alone make the policy
    # infer the fast cartesian state of distal links through the whole
    # kinematic chain; link states observe it directly (DeepMimic's 197-dim
    # humanoid obs is exactly this family). Costs one FK per reset (the
    # step reuses the physics FK outputs).
    include_link_obs: bool = False
    # -- action --
    # "absolute": action = PD target angles in radians (reference semantics,
    #             ``agent_mimic.py:58-91`` where the action IS the target);
    # "residual": action adds to the reference pose at t+dt (imitation prior);
    # "torque":   action bypasses PD and is applied as torque directly
    #             (the reference's ``step_custom_target_and_outside``,
    #             ``agent_mimic.py:239-271``).
    action_mode: str = "absolute"
    # Extra feedforward lead (seconds) on the residual-mode PD base target:
    # the base target is the reference pose at t + policy_dt +
    # ref_target_lead. A PD-driven plant realizes its target with a lag set
    # by actuator/inertia bandwidth — measured ~25-30 ms-equivalent on the
    # backflip (logs/backflip_ceiling.json: the shipped policy scores
    # between the 8 ms and 62.5 ms pure-delay envelope rows). Leading the
    # base target by that lag makes the REALIZED pose line up with the
    # reference at scoring time; the policy's residual is unchanged in
    # meaning (a correction around the base). The policy cannot emulate
    # this itself: its residual is state-feedback at the current phase and
    # the same lag applies to it. 0 = off (reference semantics).
    ref_target_lead: float = 0.0
    # implicit_pd = Stable PD fused into the integrator solve (production
    # default; same control law, one Cholesky per substep). stable_pd /
    # standard_pd / inverse_dynamics_pd mirror the reference's three
    # controller families (``pds_controllers_agents.py``).
    controller: str = "implicit_pd"
    pd_per_substep: bool = True
    # Scale the PD gain tables (control.default_gains). Closed-loop tracking
    # bandwidth grows with sqrt(kp); the DeepMimic table's kd ~ kp/10 is
    # near-critical, so kd should scale ~sqrt(kp_scale) to keep the damping
    # ratio. Untried before round 5: the backflip's residual eval loss is
    # measured SPATIAL looseness (flat cross-correlation lag landscape,
    # docs/BACKFLIP_EXPERIMENTS.md round 5), and stiffness is the direct
    # spatial-precision lever (arm X scaled torque LIMITS only). Stable-PD
    # is implicit in the integrator, so large kp stays numerically stable.
    kp_scale: float = 1.0
    kd_scale: float = 1.0
    # Torque envelope = gear * ctrlrange * torque_limit_scale. The default 2.0
    # restores DeepMimic's full-gear limits (the reference XML's ±0.5
    # ctrlrange halves them — too weak for ballistic skills like backflip).
    torque_limit_scale: float = 2.0
    # Enforce hinge range limits (compliant springs) and clip PD targets to
    # ranges. Disable for clips whose converted poses legitimately exceed the
    # reference model's ranges (backflip, kick — DeepMimic's own skeleton has
    # much wider limits).
    enforce_joint_limits: bool = True

    @property
    def n_substeps(self) -> int:
        """Physics substeps per policy step.

        Rounded like the reference's ``n_frames = int(_dt/0.002)``
        (``agent_env_template.py:68``): variant1's 1/60 s policy dt is not an
        exact multiple of 2 ms, so the *effective* policy period is
        ``n_substeps * physics_dt`` (16 ms there) — see
        :attr:`effective_policy_dt`.
        """
        n = max(1, round(self.policy_dt / self.physics_dt))
        return int(n)

    @property
    def effective_policy_dt(self) -> float:
        return self.n_substeps * self.physics_dt


@dataclasses.dataclass(frozen=True)
class VecState:
    """Batched env state: physics state plus episode bookkeeping."""

    qpos: torch.Tensor           # (B, nq)
    qvel: torch.Tensor           # (B, nv)
    time: torch.Tensor           # (B,)
    episode_start: torch.Tensor  # (B,)
    obs: torch.Tensor            # (B, obs_dim)
    reward: torch.Tensor         # (B,)
    done: torch.Tensor           # (B,)
    metrics: Dict[str, torch.Tensor]  # (B,) each

    def replace(self, **kw) -> "VecState":
        return dataclasses.replace(self, **kw)


def variant1(**kw) -> EnvConfig:
    return EnvConfig(policy_dt=1.0 / 60.0, physics_dt=0.002, **kw)


def variant2(**kw) -> EnvConfig:
    return EnvConfig(policy_dt=1.0 / 30.0, physics_dt=1.0 / 1200.0, **kw)


class Env:
    """Environment protocol: reset/step plus static sizes."""

    def reset(self, *args, **kwargs) -> State:
        raise NotImplementedError

    def step(self, state: State, action: torch.Tensor) -> State:
        raise NotImplementedError

    @property
    def observation_size(self) -> int:
        raise NotImplementedError

    @property
    def action_size(self) -> int:
        raise NotImplementedError


_REGISTRY: Dict[str, Callable[..., Env]] = {}


def register_environment(name: str, ctor: Callable[..., Env]) -> None:
    """Register an env constructor under ``name``."""
    _REGISTRY[name] = ctor


def get_environment(name: str, **kwargs) -> Env:
    if name not in _REGISTRY:
        raise KeyError(f"unknown environment {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def registered_environments():
    return sorted(_REGISTRY)


def stack_states(states):
    """Stack a list of equally shaped states (dataclasses, dicts, tensors)
    along a new leading axis."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(states)
    if isinstance(first, dict):
        return {k: stack_states([s[k] for s in states]) for k in first}
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: stack_states([getattr(s, f.name) for s in states])
            for f in dataclasses.fields(first)})
    return first
