"""Utilities: profiling scopes, numerical guards, config IO."""

from pbrl_tpu_torch.utils.profiling import profile_scope, profile_to, trace_annotation  # noqa: F401
from pbrl_tpu_torch.utils.guards import (  # noqa: F401
    assert_finite,
    check_finite_tree,
    nan_debug_enabled,
)
from pbrl_tpu_torch.utils.configio import (  # noqa: F401
    config_to_dict,
    dict_to_config,
    load_json_config,
    save_json_config,
)
