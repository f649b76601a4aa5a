"""Hydra-style YAML config composition (no Hydra, no PyYAML).

The port's counterpart of ``wav2sleep_tpu/config.py``, over the port's own
YAML subset reader (``checkpoint.yaml_load``). It covers what the configs
under ``scripts/config`` use:

- ``defaults:`` group composition (``- model: wav2sleep``,
  ``- inputs: cardiorespiratory/all``, nested defaults, ``- _self_``,
  ``null`` entries),
- interpolation: ``${path.to.key}``, ``${oc.env:VAR[,default]}``,
  ``${oc.select:path,default}``, ``${oc.dict.keys:path}``,
- command-line overrides: ``key.path=value`` (YAML-typed, lists as
  ``[a,b]``), group overrides (``model=ppgnet``, ``inputs=neural/eog``) and
  ``+key=value`` additions.
"""

from __future__ import annotations

import os
import re
from typing import Any

from .checkpoint import yaml_load, yaml_scalar

_INTERP_RE = re.compile(r'\$\{([^${}]+)\}')


class ConfigError(ValueError):
    pass


def _load_yaml(path: str) -> dict:
    with open(path, encoding='utf-8') as f:
        return yaml_load(f.read()) or {}


def _deep_merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_path(cfg: dict, dotted: str, value: Any, allow_new: bool = True) -> None:
    parts = dotted.split('.')
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            if not allow_new:
                raise ConfigError(f'Unknown config path: {dotted}')
            node[p] = {}
        node = node[p]
    if not allow_new and parts[-1] not in node:
        raise ConfigError(f'Unknown config key: {dotted}')
    node[parts[-1]] = value


def _get_path(cfg: dict, dotted: str) -> Any:
    node: Any = cfg
    for p in dotted.split('.'):
        if not isinstance(node, dict) or p not in node:
            raise KeyError(dotted)
        node = node[p]
    return node


def _compose_file(config_dir: str, rel: str, group_overrides: dict[str, str]) -> dict:
    """Load one config file, processing its ``defaults`` list."""
    path = os.path.join(config_dir, rel + '.yaml')
    if not os.path.exists(path):
        raise ConfigError(f'Config file not found: {path}')
    raw = _load_yaml(path)
    defaults = raw.pop('defaults', None)
    own = raw
    if defaults is None:
        return own
    base_dir = os.path.dirname(rel)
    cfg: dict = {}
    merged_self = False
    for entry in defaults:
        if entry == '_self_':
            cfg = _deep_merge(cfg, own)
            merged_self = True
            continue
        if isinstance(entry, str):
            # bare include: file in the same group dir
            inc = _compose_file(config_dir, os.path.join(base_dir, entry), group_overrides)
            cfg = _deep_merge(cfg, inc)
            continue
        if not isinstance(entry, dict) or len(entry) != 1:
            raise ConfigError(f'Unsupported defaults entry: {entry!r}')
        (group, name), = entry.items()
        if group.startswith('override ') or group.startswith('/'):
            continue  # hydra-internal (logging etc.) — not used here
        full_group = os.path.join(base_dir, group) if base_dir else group
        name = group_overrides.get(group, group_overrides.get(full_group.replace(os.sep, '/'), name))
        if name is None or name == 'null':
            continue
        if isinstance(name, list):
            sub: dict = {}
            for item in name:
                sub = _deep_merge(sub, _compose_file(config_dir, os.path.join(full_group, str(item)), group_overrides))
            content = sub
        else:
            content = _compose_file(config_dir, os.path.join(full_group, str(name)), group_overrides)
        # Hydra packages a group's content at its group PATH: a nested
        # group 'trainer/profiler' lands at cfg['trainer']['profiler'],
        # not at the top-level leaf key.
        for part in reversed(group.split('/')):
            content = {part: content}
        cfg = _deep_merge(cfg, content)
    if not merged_self:
        cfg = _deep_merge(cfg, own)
    return cfg


def _parse_value(text: str) -> Any:
    """An override's value as YAML reads it; the text itself where the
    subset reader refuses it."""
    try:
        return yaml_scalar(text)
    except ValueError:
        return text


def compose(config_dir: str, config_name: str = 'main', overrides: list[str] | None = None) -> dict:
    """Compose a config from groups + overrides and resolve interpolations."""
    overrides = list(overrides or [])
    group_overrides: dict[str, str] = {}
    value_overrides: list[tuple[str, Any, bool]] = []
    root_groups = {
        d for d in os.listdir(config_dir) if os.path.isdir(os.path.join(config_dir, d))
    }
    for ov in overrides:
        if '=' not in ov:
            raise ConfigError(f'Override must be key=value: {ov!r}')
        key, _, val = ov.partition('=')
        additive = key.startswith('+')
        key = key.lstrip('+')
        if not additive and '.' not in key and key.split('/')[0] in root_groups:
            group_overrides[key] = val
        else:
            value_overrides.append((key, _parse_value(val), additive))
    cfg = _compose_file(config_dir, config_name, group_overrides)
    for key, val, additive in value_overrides:
        # Hydra semantics: a plain override must target an EXISTING key (a
        # typo'd 'epcohs=5' should error, not silently add a dead key and
        # train with the default); '+key=value' explicitly adds a new one.
        _set_path(cfg, key, val, allow_new=additive)
    cfg['overrides'] = overrides
    return resolve(cfg)


def resolve(cfg: dict) -> dict:
    """Resolve ``${...}`` interpolations against the config root."""

    def resolve_expr(expr: str) -> Any:
        expr = expr.strip()
        if expr.startswith('oc.env:'):
            body = expr[len('oc.env:') :]
            var, _, default = body.partition(',')
            val = os.environ.get(var.strip())
            if val is None:
                if _ := default.strip():
                    return _parse_value(default.strip())
                if not default and ',' not in body:
                    raise ConfigError(f'Environment variable {var!r} not set.')
                return None
            return _parse_value(val)
        if expr.startswith('oc.select:'):
            body = expr[len('oc.select:') :]
            path, _, default = body.partition(',')
            try:
                return resolve_node(_get_path(cfg, path.strip()))
            except KeyError:
                d = default.strip()
                return _parse_value(d) if d and d != '.' else (d if d == '.' else None)
        if expr.startswith('oc.dict.keys:'):
            path = expr[len('oc.dict.keys:') :].strip()
            node = resolve_node(_get_path(cfg, path))
            return list(node.keys())
        return resolve_node(_get_path(cfg, expr))

    def resolve_node(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: resolve_node(v) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve_node(v) for v in node]
        if isinstance(node, str):
            full = _INTERP_RE.fullmatch(node)
            if full:
                return resolve_expr(full.group(1))
            if '${' in node:
                def repl(m):
                    v = resolve_expr(m.group(1))
                    return '' if v is None else str(v)

                return _INTERP_RE.sub(repl, node)
        return node

    return resolve_node(cfg)
