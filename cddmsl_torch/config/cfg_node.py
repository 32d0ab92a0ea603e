"""yacs-style configuration tree (the port's copy of
cddmsl_tpu/config/cfg_node.py): attribute access, `merge_from_file` with
`_BASE_` chaining, `merge_from_list` for `KEY VALUE` overrides, `freeze`
and a YAML dump.

One difference: the port's default tree (`defaults.py`) holds only the keys
the port reads or checks, and a file or an override that names any other key
raises `NotImplementedError` naming it, so no setting is dropped without a
word. Files must be at the current VERSION (2); the JAX package's upgrade of
older files is not ported.
"""

import ast
import os
from typing import Any, Dict, List

import yaml

_BASE_KEY = "_BASE_"
_VERSION = 2


class CfgNode(dict):
    """A dict with attribute access, freezing and a checked recursive merge."""

    _FROZEN = "__frozen__"

    def __init__(self, init_dict: Dict[str, Any] = None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        for k, v in (init_dict or {}).items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"CfgNode has no attribute '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    def __setitem__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode._FROZEN):
            raise AttributeError(f"Cannot set '{key}': CfgNode is frozen")
        super().__setitem__(key, value)

    def freeze(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def merge_from_file(self, cfg_filename: str) -> None:
        loaded = _load_yaml_with_base(cfg_filename)
        version = loaded.get("VERSION", _VERSION)
        if version != _VERSION:
            raise NotImplementedError(f"{cfg_filename}: VERSION {version}; the port reads version {_VERSION} only")
        _merge_a_into_b(loaded, self, ())

    def merge_from_list(self, cfg_list: List[str]) -> None:
        if len(cfg_list) % 2:
            raise ValueError(f"Override list has odd length: {cfg_list}")
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            d = self
            keys = full_key.split(".")
            for sub in keys[:-1]:
                if not isinstance(d.get(sub), CfgNode):
                    raise NotImplementedError(f"{full_key}: not a key the port reads")
                d = d[sub]
            if keys[-1] not in d:
                raise NotImplementedError(f"{full_key}: not a key the port reads")
            d[keys[-1]] = _decode_value(v, d[keys[-1]], full_key)

    def dump(self) -> str:
        return yaml.safe_dump(_to_plain_dict(self), default_flow_style=None)

    def dump_to_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dump())

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


def _to_plain_dict(cfg: CfgNode) -> Dict[str, Any]:
    return {
        k: _to_plain_dict(v) if isinstance(v, CfgNode) else (list(v) if isinstance(v, tuple) else v)
        for k, v in cfg.items()
    }


def _decode_value(v: Any, old: Any, full_key: str) -> Any:
    """A string override parsed as a Python literal, or a YAML value, checked
    against the old value's type (tuple/list interchange, int -> float,
    0/1 -> bool; None is always allowed)."""
    parsed = v
    if isinstance(v, str):
        try:
            parsed = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            parsed = v
    if old is None or parsed is None:
        return parsed
    if isinstance(old, tuple) and isinstance(parsed, list):
        parsed = tuple(parsed)
    if isinstance(old, list) and isinstance(parsed, tuple):
        parsed = list(parsed)
    if isinstance(old, float) and isinstance(parsed, int):
        parsed = float(parsed)
    if isinstance(old, bool) != isinstance(parsed, bool) and {type(old), type(parsed)} == {bool, int}:
        parsed = bool(parsed)
    if not isinstance(parsed, type(old)) and not (isinstance(old, (int, float)) and isinstance(parsed, (int, float))):
        raise ValueError(
            f"Type mismatch ({type(old).__name__} vs {type(parsed).__name__}) for key {full_key}: {old} vs {parsed}"
        )
    return parsed


def _merge_a_into_b(a: Dict[str, Any], b: CfgNode, path: tuple) -> None:
    """Merges the plain dict `a` into `b` in place; a key `b` lacks raises."""
    for k, v in a.items():
        full_key = ".".join(path + (k,))
        if k not in b:
            raise NotImplementedError(f"{full_key}: not a key the port reads")
        if isinstance(v, dict):
            if not isinstance(b[k], CfgNode):
                raise ValueError(f"{full_key}: a node in the file, a value in the defaults")
            _merge_a_into_b(v, b[k], path + (k,))
            continue
        if isinstance(v, list) and isinstance(b[k], tuple):
            v = tuple(v)
        b[k] = _decode_value(v, b[k], full_key) if b[k] is not None and v is not None else v


def _load_yaml_with_base(filename: str) -> Dict[str, Any]:
    """A YAML file with its `_BASE_` chain resolved (the base first, this
    file merged over it). The JAX package also reads the reference's `BASE_`
    spelling; so does the port."""
    with open(filename, "r") as f:
        cfg = yaml.safe_load(f) or {}
    base_key = next((k for k in (_BASE_KEY, "BASE_") if k in cfg), None)
    if base_key is None:
        return cfg
    base_filename = cfg.pop(base_key)
    if not os.path.isabs(base_filename):
        base_filename = os.path.join(os.path.dirname(filename), base_filename)
    base_cfg = _load_yaml_with_base(base_filename)
    _merge_plain(cfg, base_cfg)
    return base_cfg


def _merge_plain(src: Dict[str, Any], dst: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge_plain(v, dst[k])
        else:
            dst[k] = v
