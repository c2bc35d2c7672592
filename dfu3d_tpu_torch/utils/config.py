"""Config system: YAML tree with `_BASE_CONFIG_` inheritance and typed
dotted overrides.

Own copy of dfu3d_tpu/utils/config.py (`CfgDict`, `cfg_from_yaml_file`,
`cfg_from_list`, `log_config_to_file`): the same attribute-style dict and the
same recursive base merge, with base paths resolved relative to the including
file, then its parents, then the CWD.
"""
from __future__ import annotations

from ast import literal_eval
from pathlib import Path

import yaml


class CfgDict(dict):
    """dict with attribute access, recursively converting nested dicts."""

    def __init__(self, d=None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, CfgDict):
            value = CfgDict(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                CfgDict(x) if isinstance(x, dict) and not isinstance(x, CfgDict) else x
                for x in value
            )
        super().__setitem__(key, value)

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    def __delattr__(self, key):
        del self[key]

    def get(self, key, default=None):
        return self[key] if key in self else default


def _load_yaml(path):
    with open(path, "r") as f:
        return yaml.safe_load(f)


def _resolve_base_path(base: str, including_file: Path) -> Path:
    cand = Path(base)
    if cand.is_absolute() and cand.exists():
        return cand
    for anchor in [including_file.parent, *including_file.parents, Path.cwd()]:
        p = anchor / base
        if p.exists():
            return p
        # configs write "cfgs/dataset_configs/x.yaml" relative to tools/
        if base.startswith("cfgs/") and anchor.name == "cfgs":
            p = anchor.parent / base
            if p.exists():
                return p
    raise FileNotFoundError(f"_BASE_CONFIG_ not found: {base} (from {including_file})")


def merge_new_config(config, new_config, cfg_path: Path | None = None):
    """Recursive merge; a `_BASE_CONFIG_` key is expanded (recursively) first."""
    if "_BASE_CONFIG_" in new_config:
        base_file = _resolve_base_path(new_config["_BASE_CONFIG_"], cfg_path or Path.cwd())
        merge_new_config(config, CfgDict(_load_yaml(base_file)), base_file)

    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if not isinstance(val, dict):
            config[key] = val
            continue
        if key not in config or not isinstance(config[key], dict):
            config[key] = CfgDict()
        merge_new_config(config[key], val, cfg_path)
    return config


def cfg_from_yaml_file(cfg_file, config):
    cfg_file = Path(cfg_file)
    merge_new_config(config=config, new_config=_load_yaml(cfg_file), cfg_path=cfg_file)
    return config


def cfg_from_list(cfg_list, config):
    """Typed dotted overrides, e.g. ``--set MODEL.DENSE_HEAD.NMS_THRESH 0.7``:
    a value is parsed as a Python literal (else kept as a string) and must
    have the type of the value it replaces; a dict takes ``k1:v1,k2:v2`` and
    a list ``a,b,c``, each element cast to the type it replaces."""
    if len(cfg_list) % 2:
        raise ValueError(f"override list must be KEY VALUE pairs: {cfg_list}")
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split(".")
        d = config
        for subkey in key_list[:-1]:
            if subkey not in d:
                raise KeyError(f"NotFoundKey: {subkey}")
            d = d[subkey]
        subkey = key_list[-1]
        if subkey not in d:
            raise KeyError(f"NotFoundKey: {subkey}")
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError, TypeError):
            value = v

        if type(value) != type(d[subkey]) and isinstance(d[subkey], dict):
            for src in value.split(","):
                cur_key, cur_val = src.split(":")
                d[subkey][cur_key] = type(d[subkey][cur_key])(cur_val)
        elif type(value) != type(d[subkey]) and isinstance(d[subkey], list):
            elem_type = type(d[subkey][0]) if d[subkey] else str
            d[subkey] = [elem_type(x) for x in value.split(",")]
        elif type(value) != type(d[subkey]):
            raise TypeError(f"{k}: type {type(value)} does not match original type "
                            f"{type(d[subkey])}")
        else:
            d[subkey] = value
    return config


def log_config_to_file(cfg_, pre="cfg", logger=None):
    for key, val in cfg_.items():
        if isinstance(val, dict):
            logger.info("----------- %s -----------" % key)
            log_config_to_file(val, pre=f"{pre}.{key}", logger=logger)
            continue
        logger.info("%s.%s: %s" % (pre, key, val))
