"""Hierarchical config without yaml: the JAX package's ``Config`` class over
the port's Python presets.

Port of the JAX package's ``config.py``: attribute access
(``cfg.finetune.learning_rate``), ``get``, ``select``, ``set_dotted``,
``merge``, ``${a.b.c}`` interpolation resolved against the root, and
``to_dict``. The configs themselves are the presets in ``presets.py``
(the H100 host has no yaml), composed as ``compose`` does from the YAML
tree: defaults first, then the preset's own body, then ``key=value``
overrides, then interpolation. A resolved config is saved as JSON
(``Config.save``), which is how ``launch_mode=processes`` hands it to its
children: ``compose_saved`` reads it back with the ``+me.<key>=<value>``
overrides each child gets on its command line.
"""

from __future__ import annotations

import copy
import json
import os
import re
from pathlib import Path
from typing import Any, Iterator

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")
_MISSING = "???"


class MissingValueError(KeyError):
    pass


class Config:
    """A nested attrdict over plain dicts and lists, with interpolation."""

    def __init__(self, data: dict[str, Any] | None = None):
        # held by reference so nested views share writes with the root
        object.__setattr__(self, "_data", data if data is not None else {})

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except MissingValueError:
            raise
        except KeyError as e:
            raise AttributeError(str(e)) from None

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _unwrap(value)

    def __getitem__(self, key: str) -> Any:
        if key not in self._data:
            raise KeyError(f"Missing config key: {key!r}")
        value = self._data[key]
        if value == _MISSING:
            raise MissingValueError(f"Config key {key!r} is required (???)")
        return _wrap(value)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _unwrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return self._data == other._data
        if isinstance(other, dict):
            return self._data == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def get(self, key: str, default: Any = None) -> Any:
        if key not in self._data or self._data[key] == _MISSING:
            return default
        return _wrap(self._data[key])

    def keys(self):
        return self._data.keys()

    def items(self):
        return ((k, _wrap(v)) for k, v in self._data.items())

    def select(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Config) and part in node:
                node = node.get(part)
            else:
                return default
        return node

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self._data
        for part in parts[:-1]:
            if not isinstance(node.get(part), dict):
                node[part] = {}
            node = node[part]
        node[parts[-1]] = _unwrap(value)

    def merge(self, other: "Config | dict") -> None:
        """Deep-merge ``other`` into self (other wins)."""
        _deep_merge(self._data, _unwrap(other))

    def resolve(self) -> "Config":
        """A copy with every ``${...}`` interpolation substituted."""
        root = copy.deepcopy(self._data)
        _resolve_node(root, root, trail=())
        return Config(root)

    def to_dict(self) -> dict[str, Any]:
        return copy.deepcopy(self._data)

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._data, f, indent=1)
        os.replace(tmp, str(path))


def _wrap(value: Any) -> Any:
    return Config(value) if isinstance(value, dict) else value


def _unwrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value._data
    if isinstance(value, dict):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_unwrap(v) for v in value]
    return value


def _deep_merge(dst: dict, src: dict) -> None:
    for key, value in src.items():
        if isinstance(value, dict) and isinstance(dst.get(key), dict):
            _deep_merge(dst[key], value)
        else:
            dst[key] = copy.deepcopy(value)


def _lookup(root: dict, dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(f"Interpolation target not found: {dotted!r}")
        node = node[part]
    return node


def _resolve_value(root: dict, value: Any, trail: tuple) -> Any:
    if not isinstance(value, str):
        return value
    match = _INTERP_RE.fullmatch(value)
    if match:  # a whole-string interpolation keeps the target's type
        target = match.group(1)
        if target in trail:
            raise ValueError(f"Interpolation cycle at {target!r}")
        return _resolve_value(root, _lookup(root, target), trail + (target,))

    def sub(m: re.Match) -> str:
        resolved = _resolve_value(root, _lookup(root, m.group(1)), trail + (m.group(1),))
        return str(resolved)

    return _INTERP_RE.sub(sub, value)


def _resolve_node(root: dict, node: Any, trail: tuple) -> None:
    items = node.items() if isinstance(node, dict) else enumerate(node)
    for key, value in list(items):
        if isinstance(value, (dict, list)):
            _resolve_node(root, value, trail)
        else:
            node[key] = _resolve_value(root, value, trail)


# YAML 1.1's null and boolean words
_SPECIAL = {
    **dict.fromkeys(("null", "Null", "NULL", "~", ""), None),
    **dict.fromkeys(("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"), True),
    **dict.fromkeys(("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"), False),
}


def _split_flow(inner: str) -> list[str]:
    """The items of a flow collection's body: split at the commas outside
    nested brackets, braces and quotes."""
    parts, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(inner):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(inner[start:i])
            start = i + 1
    return [*parts, inner[start:]]


def parse_value(text: str) -> Any:
    """A ``key=value`` override's value, as the JAX CLI's YAML scalars read
    it: JSON numbers, booleans, null, quoted strings and lists; ``[a, b]``
    flow lists and ``{k: v}`` flow maps of bare words, nested; anything else
    a plain string."""
    text = text.strip()
    if text in _SPECIAL:
        return _SPECIAL[text]
    try:
        return json.loads(text)
    except ValueError:
        pass
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [parse_value(part) for part in _split_flow(inner)] if inner else []
    if text.startswith("{") and text.endswith("}"):
        inner = text[1:-1].strip()
        pairs = [part.partition(": ") for part in _split_flow(inner)] if inner else []
        return {parse_value(k): parse_value(v) if sep else None for k, sep, v in pairs}
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    try:
        return float(text)  # 1e-5, .5, 1.e3: YAML 1.2 floats that JSON refuses
    except ValueError:
        return text


def compose(config_name: str, overrides: list[str] | None = None, resolve: bool = True) -> Config:
    """The preset ``config_name`` (``presets.py``) with ``key=value``
    overrides applied (a leading ``+`` is accepted and ignored, as the JAX
    CLI accepts it), then resolved. An override ``<group>=<entry>`` of a
    config group (``finetune=ppo``) selects that group's entry, as a
    defaults entry would, before the preset's own bodies merge over it."""
    from .presets import is_group, preset

    groups, pairs = {}, []
    for ov in overrides or []:
        body = ov[1:] if ov.startswith("+") else ov
        if "=" not in body:
            raise ValueError(f"Override {ov!r} must be key=value")
        key, _, raw = body.partition("=")
        key, value = key.strip(), parse_value(raw)
        if is_group(key) and isinstance(value, str):
            groups[key] = value
        else:
            pairs.append((key, value))
    cfg = preset(config_name, groups)
    for key, value in pairs:
        cfg.set_dotted(key, value)
    return cfg.resolve() if resolve else cfg


def compose_saved(config_dir: str | Path, config_name: str, overrides: list[str] | None = None) -> Config:
    """The config ``Config.save`` wrote to ``<config_dir>/<config_name>.json``
    with ``key=value`` overrides applied (a leading ``+`` is accepted, as in
    the ``+me.port=8080`` a launcher passes each child), then resolved."""
    path = Path(config_dir) / f"{config_name}.json"
    with open(path) as f:
        cfg = Config(json.load(f))
    for ov in overrides or []:
        body = ov[1:] if ov.startswith("+") else ov
        if "=" not in body:
            raise ValueError(f"Override {ov!r} must be key=value")
        key, _, raw = body.partition("=")
        cfg.set_dotted(key.strip(), parse_value(raw))
    return cfg.resolve()
