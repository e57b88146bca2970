"""Training: networks, obs normalisation, the optimiser, PPO, analytic
policy gradients (APG), evaluation and checkpoints."""

from pbrl_tpu_torch.train import checkpoint, networks, optim, ppo, running_stats  # noqa: F401
from pbrl_tpu_torch.train.ppo import TrainConfig, compute_gae, evaluate, train  # noqa: F401
from pbrl_tpu_torch.train import apg  # noqa: F401
from pbrl_tpu_torch.train.apg import APGConfig, make_apg_functions  # noqa: F401
from pbrl_tpu_torch.train.apg import train as train_apg  # noqa: F401
