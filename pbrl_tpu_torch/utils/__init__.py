"""Utilities: config serialisation."""

from pbrl_tpu_torch.utils.configio import config_to_dict, dict_to_config  # noqa: F401
