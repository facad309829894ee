"""Typed configuration: one system in place of the reference's four.

Counterpart of ``mapping_private_tpu/pipeline/config.py`` (the reference
configures through parameter-server reads, launch-file <param> blocks,
YAML pipeline descriptions and Param::readParam key: value files,
color_voxel_recognition param.h:42-80).  Every op or model declares a
dataclass config; this module loads one from a dict, YAML (PyYAML,
imported only when a YAML file is read) or param.txt, with type coercion
and unknown-key checks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T")


def config_from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Build a (possibly nested) dataclass config from a plain dict.

    Unknown keys raise; values are coerced to the declared field type.
    """
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass config")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in fields:
            raise KeyError(
                f"unknown config key '{k}' for {cls.__name__} "
                f"(valid: {sorted(fields)})"
            )
        ftype = fields[k].type
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            v = config_from_dict(ftype, v)
        elif ftype in (int, "int"):
            v = int(v)
        elif ftype in (float, "float"):
            v = float(v)
        elif ftype in (bool, "bool"):
            v = v if isinstance(v, bool) else str(v).lower() in ("1", "true", "yes")
        kwargs[k] = v
    return cls(**kwargs)


def config_to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def load_yaml_config(cls: Type[T], path: str) -> T:
    import yaml

    with open(path) as fp:
        return config_from_dict(cls, yaml.safe_load(fp) or {})


def load_param_txt(path: str) -> Dict[str, str]:
    """Parse the reference's `param/parameters.txt` key: value format
    (Param::readParam, param.h:42-80) into a plain dict; combine with
    config_from_dict for typing."""
    out: Dict[str, str] = {}
    with open(path) as fp:
        for line in fp:
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            k, v = line.split(":", 1)
            out[k.strip()] = v.strip()
    return out
