# Mirrors llm_bci_tpu/config.py (host code that imports no JAX): the port keeps its own copy.
"""Config system: YAML + ``include:`` expansion + deep merge + dotted CLI kwargs.

Reimplements the public behavior of the reference config layer
(``utils/config_utils.py:6-141`` in colehurwitz/llm_bci):

* :class:`DictConfig` — a ``dict`` subclass with attribute (dot) access that
  wraps nested dicts on the fly (reference ``utils/config_utils.py:6-15``).
* ``include:<path>`` string leaves are expanded recursively into the yaml
  file they point to (reference ``utils/config_utils.py:20-30``).
* :func:`update_config` deep-merges an override config into a default config,
  creating missing keys (reference ``utils/config_utils.py:36-75``).
* :func:`config_from_kwargs` turns flat ``a.b.c=value`` CLI kwargs into a
  nested config with typed leaves (reference ``utils/config_utils.py:123-141``).
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Mapping, Optional, Union

import yaml

ConfigLike = Union[str, Mapping, None]


class DictConfig(dict):
    """Dot-access dict. Nested dicts are wrapped as :class:`DictConfig` on read."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(value, dict) and not isinstance(value, DictConfig):
            value = DictConfig(value)
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def get_dict(self) -> dict:
        """Plain-dict view (deep) — useful for serialization."""
        return to_plain_dict(self)


def to_plain_dict(config: Any) -> Any:
    """Recursively convert DictConfig trees into plain dicts (yaml-safe)."""
    if isinstance(config, Mapping):
        return {k: to_plain_dict(v) for k, v in config.items()}
    if isinstance(config, (list, tuple)):
        return [to_plain_dict(v) for v in config]
    return config


def _load_yaml(path: str) -> Any:
    if not os.path.exists(path):
        path = resolve_path(path)
    with open(path, "r") as f:
        return yaml.safe_load(f)


def expand_includes(node: Any) -> Any:
    """Recursively expand ``include:<path>`` string leaves into yaml contents.

    Matches reference ``unpack_config_rec`` (``utils/config_utils.py:20-30``):
    a string leaf whose text before the first ``:`` equals ``include`` is
    replaced by the parsed yaml file at the path after the ``:``. Expansion
    recurses into the included file as well.
    """
    if isinstance(node, str) and node.split(":", 1)[0] == "include":
        node = _load_yaml(node.split(":", 1)[1])
    if isinstance(node, Mapping):
        return {k: expand_includes(v) for k, v in node.items()}
    return node


def _deep_merge(base: Any, override: Any) -> Any:
    """Merge ``override`` into ``base``; dict values merge recursively,
    any other override value (including ``None``) replaces the base leaf.
    New keys from ``override`` are created (reference
    ``update_config_rec``, ``utils/config_utils.py:36-52``)."""
    if isinstance(override, Mapping):
        merged = dict(base) if isinstance(base, Mapping) else {}
        for key, value in override.items():
            merged[key] = _deep_merge(merged.get(key), value)
        return merged
    return override


def update_config(default_config: ConfigLike, config: ConfigLike = None) -> DictConfig:
    """Deep-merge ``config`` over ``default_config`` with include expansion.

    Either argument may be a path to a yaml file, a mapping, or ``None``.
    When ``config`` is ``None`` the default is returned with its includes
    expanded (reference ``update_config``, ``utils/config_utils.py:59-75``).
    """
    if isinstance(default_config, str):
        default_config = _load_yaml(default_config)
    if isinstance(config, str):
        config = _load_yaml(config)
    default_config = expand_includes(default_config if default_config is not None else {})
    config = expand_includes(config if config is not None else {})
    return DictConfig(_deep_merge(default_config, config))


class ParseKwargs(argparse.Action):
    """argparse action collecting ``key=value`` pairs into a dict
    (reference ``utils/config_utils.py:84-89``). Unlike the reference,
    repeated ``-k`` flags ACCUMULATE instead of silently replacing the
    earlier dict (``-k a=1 -k b=2`` == ``-k a=1 b=2``); later pairs win
    on key collision."""

    def __call__(self, parser, namespace, values, option_string=None):
        kwargs: Dict[str, str] = dict(getattr(namespace, self.dest, None) or {})
        for item in values:
            key, _, value = item.partition("=")
            kwargs[key] = value
        setattr(namespace, self.dest, kwargs)


def convert_to_dtype(value: str) -> Any:
    """Convert a CLI string flag to list/None/bool/int/float, else keep str
    (reference ``utils/config_utils.py:94-118``)."""
    if not isinstance(value, str):
        return value
    value = value.strip()
    if value.startswith("[") and value.endswith("]"):
        inner = value[1:-1]
        return [convert_to_dtype(v) for v in inner.split(",")] if inner else []
    if value in ("null", "None", "none"):
        return None
    if value in ("true", "True"):
        return True
    if value in ("false", "False"):
        return False
    if value.isdigit() or value.replace("-", "", 1).isdigit():
        try:
            return int(value)
        except ValueError:
            pass
    try:
        return float(value)
    except ValueError:
        return value


def config_from_kwargs(kwargs: Optional[Mapping], convert: bool = True) -> DictConfig:
    """Flat ``{"a.b.c": "1"}`` kwargs → nested ``{"a": {"b": {"c": 1}}}``
    (reference ``utils/config_utils.py:123-141``; the ``convert`` flag covers
    the trainer's wandb-sweep path which passes pre-typed values)."""
    config: Dict[str, Any] = {}
    if kwargs:
        for dotted_key, raw in kwargs.items():
            value = convert_to_dtype(raw) if convert else raw
            node = config
            *parents, leaf = dotted_key.split(".")
            for part in parents:
                node = node.setdefault(part, {})
                if not isinstance(node, dict):
                    raise ValueError(f"CLI key {dotted_key!r} collides with a non-dict value")
            node[leaf] = value
    return DictConfig(config)


def resolve_path(path: str, anchor_file: Optional[str] = None) -> str:
    """Resolve a config-relative path against the repo root."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    root = os.path.dirname(os.path.dirname(os.path.abspath(anchor_file or __file__)))
    candidate = os.path.join(root, path)
    return candidate if os.path.exists(candidate) else path
