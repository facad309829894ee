"""Typed configs, the op registry and DAG runner, scan acquisition."""
from mapping_private_tpu_torch.pipeline.config import (
    config_from_dict,
    config_to_dict,
    load_yaml_config,
    load_param_txt,
)
from mapping_private_tpu_torch.pipeline.dag import (
    OpSpec,
    Stage,
    Pipeline,
    register_op,
    get_op,
    registered_ops,
)

__all__ = [
    "config_from_dict",
    "config_to_dict",
    "load_yaml_config",
    "load_param_txt",
    "OpSpec",
    "Stage",
    "Pipeline",
    "register_op",
    "get_op",
    "registered_ops",
]
