"""Training: networks, obs normalisation, the optimiser, PPO, evaluation
and checkpoints."""

from pbrl_tpu_torch.train import checkpoint, networks, optim, ppo, running_stats  # noqa: F401
from pbrl_tpu_torch.train.ppo import TrainConfig, compute_gae, evaluate, train  # noqa: F401
