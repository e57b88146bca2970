"""Model layer: spec builder, compiled Model (host numpy), MJCF subset IO."""

from pbrl_tpu_torch.model.spec import (  # noqa: F401
    ActuatorSpec,
    BodySpec,
    GeomSpec,
    GeomType,
    JointSpec,
    JointType,
    Model,
    ModelSpec,
    Option,
    SiteSpec,
)
from pbrl_tpu_torch.model.builders import (  # noqa: F401
    humanoid_model,
    humanoid_spec,
    sphere_model,
    sphere_scene_spec,
)
from pbrl_tpu_torch.model.mjcf import load_model, load_spec, to_mjcf  # noqa: F401
