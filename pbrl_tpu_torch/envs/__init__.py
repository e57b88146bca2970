"""Environments: replay and mimic over the engine, the vectorized mimic env
over the policy-step kernel, and the registry."""

from pbrl_tpu_torch.envs.base import (  # noqa: F401
    Env,
    EnvConfig,
    State,
    VecState,
    get_environment,
    register_environment,
    registered_environments,
    variant1,
    variant2,
)
from pbrl_tpu_torch.envs.replay import ReplayEnv  # noqa: F401
from pbrl_tpu_torch.envs.mimic import MimicEnv  # noqa: F401
from pbrl_tpu_torch.envs.vec import MimicVecEnv  # noqa: F401
from pbrl_tpu_torch.envs import humanoid_task  # noqa: F401


def _make_replay(clip="walk", config=None, device="cuda", **kw):
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model

    clip = load_clip(clip, device=device) if isinstance(clip, str) else clip
    return ReplayEnv(humanoid_model(), clip, config or EnvConfig(), **kw)


def _make_mimic(clip="walk", config=None, gravity=True, device="cuda", **kw):
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model

    clip = load_clip(clip, device=device) if isinstance(clip, str) else clip
    return MimicEnv(humanoid_model(gravity=gravity), clip, config or EnvConfig(), **kw)


# the names of pbrl_tpu's registry
register_environment("humanoid_replay", _make_replay)
register_environment("humanoid_mimic", _make_mimic)
