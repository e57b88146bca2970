"""Trajectory export (the rendering of pbrl_tpu's ``viz`` needs MuJoCo and
is not ported)."""

from pbrl_tpu_torch.viz.render import dump_trajectory, load_trajectory  # noqa: F401
