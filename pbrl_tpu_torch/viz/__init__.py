"""Trajectory export and host-side rendering (never on the card)."""

from pbrl_tpu_torch.viz.render import (  # noqa: F401
    dump_trajectory,
    load_trajectory,
    render_video,
    save_video,
)
