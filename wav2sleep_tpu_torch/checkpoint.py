"""Checkpoint folders: ``config.yaml`` plus ``state_dict.pth`` or ``params.npz``.

The port's counterpart of ``wav2sleep_tpu/checkpoint.py`` for the formats a
deployable folder holds:

- ``config.yaml``: the model's Hydra-style ``_target_`` config, read and
  written by the YAML subset below;
- ``state_dict.pth``: a torch ``state_dict`` with the reference's names and
  layouts, which the port's models take as it is;
- ``params.npz``: the JAX package's flattened variables (``path|to|leaf``
  keys), turned into a ``state_dict`` by ``convert.from_jax_variables``.

The YAML subset is what ``yaml.safe_dump(cfg, sort_keys=False)`` writes for a
model config and what the training configs under ``scripts/config`` and
their command-line overrides use: block mappings and sequences, plain and
quoted strings, int, float, bool, null, the empty ``[]`` and ``{}`` and flow
sequences of scalars (``[mesa, shhs]``). The reader also skips comments.
Anything else (anchors, tags, nested or mapping flow collections, block or
multi-line scalars, several documents) is refused with a ``ValueError``,
never guessed.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

from .convert import from_jax_variables

_SEP = '|'


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_params_npz(path: str) -> dict:
    """The JAX package's ``params.npz`` as its nested variables tree."""
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def read_config(folder: str) -> dict:
    """The folder's ``config.yaml``."""
    path = os.path.join(folder, 'config.yaml')
    if not os.path.exists(path):
        raise FileNotFoundError(f'No config file found at {path}. Has the model been downloaded?')
    with open(path, encoding='utf-8') as f:
        return yaml_load(f.read())


def load_state_dict(folder: str, family: str = 'wav2sleep') -> dict[str, torch.Tensor]:
    """The folder's weights as a ``state_dict`` of the port's ``family``
    model: ``state_dict.pth``, else ``params.npz``."""
    pth = os.path.join(folder, 'state_dict.pth')
    npz = os.path.join(folder, 'params.npz')
    if os.path.exists(pth):
        return torch.load(pth, map_location='cpu', weights_only=True)
    if os.path.exists(npz):
        return from_jax_variables(load_params_npz(npz), family)
    raise FileNotFoundError(f'No state dict found at {pth}. Has the model been downloaded?')


def save_checkpoint_folder(folder: str, config: dict, state_dict: dict[str, torch.Tensor]) -> None:
    """Write a deployable folder: ``config.yaml`` and ``state_dict.pth``
    (floating tensors, batch norm's running statistics among them, as f32
    on the CPU), which both packages' loaders and the reference's read;
    the JAX package's reader refuses weight norm's ``weight_v`` /
    ``weight_g``, which cross to it only through its own ``params.npz``."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, 'config.yaml'), 'w', encoding='utf-8') as f:
        f.write(yaml_dump(config))
    sd = {k: (v.detach().to('cpu', torch.float32) if v.is_floating_point() else v.detach().cpu()).contiguous()
          for k, v in state_dict.items()}
    torch.save(sd, os.path.join(folder, 'state_dict.pth'))


# --- The YAML subset -------------------------------------------------------

# PyYAML's implicit resolvers (YAML 1.1), which decide what a plain scalar is.
_BOOL = {'yes': True, 'Yes': True, 'YES': True, 'true': True, 'True': True, 'TRUE': True, 'on': True,
         'On': True, 'ON': True, 'no': False, 'No': False, 'NO': False, 'false': False, 'False': False,
         'FALSE': False, 'off': False, 'Off': False, 'OFF': False}
_NULL = {'', '~', 'null', 'Null', 'NULL'}
_INT_DECIMAL = re.compile(r'[-+]?(?:0|[1-9][0-9_]*)')
_INT_OTHER = re.compile(r'[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+')
_FLOAT = re.compile(r'[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?')
_FLOAT_SPECIAL = {'.inf': np.inf, '.Inf': np.inf, '.INF': np.inf, '+.inf': np.inf, '+.Inf': np.inf,
                  '+.INF': np.inf, '-.inf': -np.inf, '-.Inf': -np.inf, '-.INF': -np.inf,
                  '.nan': np.nan, '.NaN': np.nan, '.NAN': np.nan}
_FLOAT_OTHER = re.compile(r'[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*')
# Plain strings the writer leaves unquoted: a conservative part of what
# PyYAML leaves plain.
_PLAIN_STR = re.compile(r"(?!-$)[A-Za-z0-9_./$-][A-Za-z0-9_./${}:+'-]*")


def _resolve_plain(text: str, where: str) -> Any:
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT_DECIMAL.fullmatch(text):
        return int(text.replace('_', ''))
    if text in _FLOAT_SPECIAL:
        return float(_FLOAT_SPECIAL[text])
    if _FLOAT.fullmatch(text):
        return float(text.replace('_', ''))
    if _INT_OTHER.fullmatch(text) or _FLOAT_OTHER.fullmatch(text):
        raise ValueError(f'{where}: {text!r} is a YAML number form this reader does not take')
    return text


_ESCAPES = {'0': '\0', 'a': '\a', 'b': '\b', 't': '\t', 'n': '\n', 'v': '\v', 'f': '\f', 'r': '\r',
            'e': '\x1b', ' ': ' ', '"': '"', '/': '/', '\\': '\\', 'N': '\x85', '_': '\xa0'}
_HEX_ESCAPES = {'x': 2, 'u': 4, 'U': 8}


def _quoted(text: str, where: str) -> tuple[str, str]:
    """A quoted scalar at the start of ``text``: (its value, the rest)."""
    q, out, i = text[0], [], 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return ''.join(out), text[i + 1 :]
        if q == '"' and c == '"':
            return ''.join(out), text[i + 1 :]
        if q == '"' and c == '\\':
            e = text[i + 1 : i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX_ESCAPES:
                digits = text[i + 2 : i + 2 + _HEX_ESCAPES[e]]
                if len(digits) == _HEX_ESCAPES[e] and all(d in '0123456789abcdefABCDEF' for d in digits):
                    out.append(chr(int(digits, 16)))
                    i += 2 + len(digits)
                    continue
            raise ValueError(f'{where}: unsupported escape in a double-quoted string')
        out.append(c)
        i += 1
    raise ValueError(f'{where}: a quoted string must close on its line (multi-line scalars are not supported)')


def _scalar(text: str, where: str) -> Any:
    """The value of a scalar written after ``key: `` or ``- ``."""
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, where)
        rest = rest.strip()
        if rest and not rest.startswith('#'):
            raise ValueError(f'{where}: unexpected text after a quoted string')
        return value
    text = _strip_comment(text)
    if not text:
        return None
    if text == '{}':
        return {}
    if text[:1] == '[' and text.endswith(']'):
        return _flow_sequence(text[1:-1], where)
    if text[:1] in '[{':
        raise ValueError(f'{where}: flow collections other than [...] of scalars and {{}} are not supported')
    if text[:1] in '&*!|>%@`?' or text in ('-', '---', '...') or text.startswith('- '):
        raise ValueError(f'{where}: {text!r}: anchors, aliases, tags, block scalars and the like are not supported')
    if ': ' in text or text.endswith(':'):
        raise ValueError(f'{where}: a mapping cannot start after a key on the same line')
    return _resolve_plain(text, where)


def _flow_sequence(body: str, where: str) -> list:
    """The items of a flow sequence ``[a, 'b', 1]`` (its text between the
    brackets): plain or quoted scalars, a trailing comma allowed."""
    items: list = []
    rest = body.strip()
    while rest:
        if rest[:1] in ("'", '"'):
            value, rest = _quoted(rest, where)
            rest = rest.strip()
        else:
            cut = rest.find(',')
            text = (rest if cut < 0 else rest[:cut]).strip()
            rest = '' if cut < 0 else rest[cut:]
            if not text or text[:1] in '[]{}&*!|>%@`#' or ': ' in text or text.endswith(':'):
                raise ValueError(f'{where}: flow sequences take plain or quoted scalars only, got {text!r}')
            value = _resolve_plain(text, where)
        items.append(value)
        if rest and not rest.startswith(','):
            raise ValueError(f'{where}: expected "," between the items of a flow sequence')
        rest = rest[1:].strip()
    return items


def _strip_comment(text: str) -> str:
    if text.startswith('#'):
        return ''
    cut = text.find(' #')
    return (text if cut < 0 else text[:cut]).strip()


def _split_key(content: str, where: str) -> tuple[Any, str] | None:
    """``(key, rest)`` when ``content`` is a mapping entry ``key: rest``."""
    if content[:1] in ("'", '"'):
        key, rest = _quoted(content, where)
        if rest == ':' or rest.startswith(': '):
            return key, rest[1:].strip()
        return None
    m = re.search(r':(?: |$)', content)
    key = '' if m is None else content[: m.start()].strip()
    if m is None or ' #' in key or key.startswith('#'):
        return None  # no key, or the colon is in a comment
    if not key or (key[0] in '&*!|>%@`?[{-' and not re.fullmatch(r'-[^ ].*', key)):
        raise ValueError(f'{where}: unsupported mapping key {key!r}')
    return _resolve_plain(key, where), content[m.end() :].strip()


class _Lines:
    def __init__(self, text: str):
        self.items: list[list] = []  # [indent, content, line number]
        for no, raw in enumerate(text.splitlines(), 1):
            stripped = raw.lstrip(' ')
            if not stripped.strip() or stripped.startswith('#'):
                continue
            if stripped[0] == '\t' or '\t' in raw[: len(raw) - len(stripped)]:
                raise ValueError(f'line {no}: tabs in indentation are not supported')
            if raw.startswith(('---', '...')):
                raise ValueError(f'line {no}: document markers are not supported (one document only)')
            self.items.append([len(raw) - len(stripped), stripped.rstrip(), no])


def _is_item(content: str) -> bool:
    return content == '-' or content.startswith('- ')


def _block(lines: _Lines, pos: int, indent: int) -> tuple[Any, int]:
    if _is_item(lines.items[pos][1]):
        return _sequence(lines, pos, indent)
    return _mapping(lines, pos, indent)


def _nested(lines: _Lines, pos: int, indent: int, in_mapping: bool) -> tuple[Any, int]:
    """The value of an entry with nothing after its ``:`` or ``-`` at
    ``pos - 1``: a block indented further, the sequence that follows a
    mapping key at its own indent, or null."""
    items = lines.items
    if pos < len(items) and items[pos][0] > indent:
        return _block(lines, pos, items[pos][0])
    if in_mapping and pos < len(items) and items[pos][0] == indent and _is_item(items[pos][1]):
        return _sequence(lines, pos, indent)
    return None, pos


def _after_scalar(lines: _Lines, pos: int, indent: int) -> None:
    if pos < len(lines.items) and lines.items[pos][0] > indent:
        raise ValueError(f'line {lines.items[pos][2]}: unexpected indentation (multi-line scalars are not supported)')


def _mapping(lines: _Lines, pos: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    items = lines.items
    while pos < len(items) and items[pos][0] == indent and not _is_item(items[pos][1]):
        _, content, no = items[pos]
        where = f'line {no}'
        entry = _split_key(content, where)
        if entry is None:
            raise ValueError(f'{where}: expected "key: value", got {content!r}')
        key, rest = entry
        if key in out:
            raise ValueError(f'{where}: duplicate key {key!r}')
        rest = rest if rest[:1] in ("'", '"') else _strip_comment(rest)
        if rest:
            out[key] = _scalar(rest, where)
            pos += 1
            _after_scalar(lines, pos, indent)
        else:
            out[key], pos = _nested(lines, pos + 1, indent, in_mapping=True)
    return out, pos


def _sequence(lines: _Lines, pos: int, indent: int) -> tuple[list, int]:
    out: list = []
    items = lines.items
    while pos < len(items) and items[pos][0] == indent and _is_item(items[pos][1]):
        _, content, no = items[pos]
        where = f'line {no}'
        rest = content[2:].strip() if content != '-' else ''
        if rest.startswith('#'):
            rest = ''
        if not rest:
            value, pos = _nested(lines, pos + 1, indent, in_mapping=False)
        elif _is_item(rest) or _split_key(rest, where) is not None:
            # "- key: v" or "- - v": a block that starts on the item's line,
            # at the column after "- ".
            col = indent + len(content) - len(rest)
            items[pos] = [col, rest, no]
            value, pos = _block(lines, pos, col)
        else:
            value = _scalar(rest, where)
            pos += 1
            _after_scalar(lines, pos, indent)
        out.append(value)
    return out, pos


def yaml_load(text: str) -> Any:
    """Parse the YAML subset (see the module docstring); what
    ``yaml.safe_load`` gives for it."""
    lines = _Lines(text)
    if not lines.items:
        return None
    value, pos = _block(lines, 0, lines.items[0][0])
    if pos != len(lines.items):
        raise ValueError(f'line {lines.items[pos][2]}: unexpected indentation or content')
    return value


def yaml_scalar(text: str) -> Any:
    """One scalar or flow sequence of the subset, as ``yaml.safe_load``
    reads it (``'1'`` -> 1, ``'[a,b]'`` -> ['a', 'b'], ``''`` -> None)."""
    return _scalar(text.strip(), 'value')


def _dump_scalar(v: Any) -> str:
    if v is None:
        return 'null'
    if isinstance(v, bool):
        return 'true' if v else 'false'
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return '.nan'
        if v in (np.inf, -np.inf):
            return '.inf' if v > 0 else '-.inf'
        text = repr(v).lower()
        # repr(1e-05) is '1e-05', which YAML 1.1 reads as a string.
        return text.replace('e', '.0e', 1) if '.' not in text and 'e' in text else text
    if isinstance(v, str):
        if _PLAIN_STR.fullmatch(v) and not v.endswith(':') and _reads_as_str(v):
            return v
        if v.isascii() and v.isprintable():
            return "'" + v.replace("'", "''") + "'"
        raise ValueError(f'cannot write {v!r}: only printable ASCII strings are supported')
    if isinstance(v, list) and not v:
        return '[]'
    if isinstance(v, dict) and not v:
        return '{}'
    raise ValueError(f'cannot write a {type(v).__name__} to YAML: only dict, list, str, int, float, bool and None')


def _reads_as_str(text: str) -> bool:
    """Whether ``text``, left plain, reads back as a string."""
    try:
        return isinstance(_resolve_plain(text, 'value'), str)
    except ValueError:
        return False  # a number form the reader refuses: quote it


def _dump_mapping(d: dict, indent: int, out: list[str], lead: str | None = None) -> None:
    for i, (k, v) in enumerate(d.items()):
        if not isinstance(k, str):
            raise ValueError(f'cannot write the key {k!r}: only string keys are supported')
        prefix = lead if (i == 0 and lead is not None) else ' ' * indent
        key = _dump_scalar(k)
        if isinstance(v, dict) and v:
            out.append(f'{prefix}{key}:')
            _dump_mapping(v, indent + 2, out)
        elif isinstance(v, list) and v:
            out.append(f'{prefix}{key}:')
            _dump_sequence(v, indent, out)
        else:
            out.append(f'{prefix}{key}: {_dump_scalar(v)}')


def _dump_sequence(items: list, indent: int, out: list[str], lead: str | None = None) -> None:
    for i, v in enumerate(items):
        prefix = (lead if (i == 0 and lead is not None) else ' ' * indent) + '- '
        if isinstance(v, dict) and v:
            _dump_mapping(v, indent + 2, out, lead=prefix)
        elif isinstance(v, list) and v:
            _dump_sequence(v, indent + 2, out, lead=prefix)
        else:
            out.append(prefix + _dump_scalar(v))


def _as_lists(node: Any) -> Any:
    """``node`` with every tuple a list, as PyYAML's safe dumper writes it."""
    if isinstance(node, dict):
        return {k: _as_lists(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_as_lists(v) for v in node]
    return node


def yaml_dump(config: dict) -> str:
    """A config (dicts with string keys, lists or tuples, str, int, float,
    bool, None) as block YAML, in the layout ``yaml.safe_dump(config,
    sort_keys=False)`` gives it."""
    if not isinstance(config, dict):
        raise ValueError('the YAML writer takes a mapping at the top')
    if not config:
        return '{}\n'
    out: list[str] = []
    _dump_mapping(_as_lists(config), 0, out)
    return '\n'.join(out) + '\n'
