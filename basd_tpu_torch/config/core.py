"""Minimal Hydra/OmegaConf-compatible config system.

Reproduces the config surface of the reference (reference:
``configs/config.yaml``, ``src/resolvers.py:18-21``, CLI overrides via
``hydra.main``) without depending on hydra-core/omegaconf (not available in
this environment):

- a base YAML with a ``defaults`` list containing ``_self_`` and
  ``optional experiment: null``;
- experiment overlay files under ``configs/experiment/*.yaml`` whose
  ``# @package _global_`` header means "merge at config root";
- dotted-key CLI overrides (``training.num_epochs=5``), ``+new.key=v`` to
  add keys, and ``experiment=<name>`` to select the overlay;
- ``${a.b}`` interpolation and ``${resolver:arg,...}`` custom resolvers.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Callable

import yaml

_RESOLVERS: dict[str, Callable[..., Any]] = {}


class _Loader(yaml.SafeLoader):
    """SafeLoader with YAML-1.2-style float parsing so '5e-4' is a float
    (matching OmegaConf), not a string (YAML 1.1 default)."""


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+]?[0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _yaml_load(stream):
    return yaml.load(stream, Loader=_Loader)


def register_resolver(name: str, fn: Callable[..., Any]) -> None:
    _RESOLVERS[name] = fn


class ConfigNode:
    """Attribute-accessible nested config (OmegaConf DictConfig stand-in)."""

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = _wrap(v)

    # -- mapping protocol -------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if key in data:
            return data[key]
        raise AttributeError(f"config key not found: {key!r}")

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __eq__(self, other) -> bool:
        if isinstance(other, ConfigNode):
            return self.to_dict() == other.to_dict()
        if isinstance(other, dict):
            return self.to_dict() == other
        return NotImplemented

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def values(self):
        return self._data.values()

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"

    def to_dict(self) -> dict:
        out = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return out

    # -- dotted-path access ------------------------------------------------
    def select(self, path: str, default: Any = ...) -> Any:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, ConfigNode) and part in node:
                node = node[part]
            elif isinstance(node, (list, tuple)) and part.lstrip("-").isdigit():
                node = node[int(part)]
            else:
                if default is ...:
                    raise KeyError(f"config path not found: {path!r}")
                return default
        return node

    def update_path(self, path: str, value: Any, *, allow_new: bool = True) -> None:
        parts = path.split(".")
        node: ConfigNode = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], ConfigNode):
                if not allow_new and part not in node:
                    raise KeyError(f"unknown config section: {part!r} in {path!r}")
                node[part] = ConfigNode()
            node = node[part]
        if not allow_new and parts[-1] not in node:
            raise KeyError(
                f"unknown config key: {path!r} (use +{path} to add new keys)"
            )
        node[parts[-1]] = value


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return value
    if isinstance(value, dict):
        return ConfigNode(value)
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def _merge(base: ConfigNode, overlay: ConfigNode) -> None:
    for key, value in overlay.items():
        if (
            key in base
            and isinstance(base[key], ConfigNode)
            and isinstance(value, ConfigNode)
        ):
            _merge(base[key], value)
        else:
            base[key] = value


# -- interpolation -----------------------------------------------------------

_SCALAR_RE = re.compile(r"^\$\{([^{}]*(?:\$\{[^{}]*\}[^{}]*)*)\}$")


def _parse_scalar(text: str) -> Any:
    """YAML-parse an override value string (so '5' -> int, 'null' -> None)."""
    try:
        return _yaml_load(text)
    except yaml.YAMLError:
        return text


def _split_args(body: str) -> list[str]:
    """Split resolver args on commas at brace depth 0."""
    args, depth, cur = [], 0, []
    for ch in body:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == "," and depth == 0:
            args.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    args.append("".join(cur))
    return args


class _Resolver:
    def __init__(self, root: ConfigNode):
        self.root = root
        self._stack: list[str] = []

    def resolve_value(self, value: Any) -> Any:
        if isinstance(value, str):
            return self._resolve_str(value)
        if isinstance(value, ConfigNode):
            for k in list(value.keys()):
                value[k] = self.resolve_value(value[k])
            return value
        if isinstance(value, list):
            return [self.resolve_value(v) for v in value]
        return value

    def _resolve_str(self, text: str) -> Any:
        m = _SCALAR_RE.match(text.strip())
        if m:
            return self._resolve_expr(m.group(1))
        # string with embedded interpolations -> string concatenation
        out, i = [], 0
        while i < len(text):
            if text.startswith("${", i):
                depth, j = 0, i
                while j < len(text):
                    if text.startswith("${", j):
                        depth += 1
                        j += 2
                        continue
                    if text[j] == "}":
                        depth -= 1
                        if depth == 0:
                            break
                    j += 1
                out.append(str(self._resolve_expr(text[i + 2 : j])))
                i = j + 1
            else:
                out.append(text[i])
                i += 1
        return "".join(out)

    def _resolve_expr(self, body: str) -> Any:
        if body in self._stack:
            raise ValueError(f"circular interpolation: {body!r}")
        self._stack.append(body)
        try:
            if ":" in body.split("${")[0].split(".")[0]:
                name, _, argstr = body.partition(":")
                name = name.strip()
                if name not in _RESOLVERS:
                    raise KeyError(f"unknown resolver: {name!r}")
                args = [
                    self.resolve_value(_parse_scalar(a.strip()))
                    for a in _split_args(argstr)
                ]
                return _RESOLVERS[name](*args)
            path = self._resolve_str(body) if "${" in body else body
            return self.resolve_value(self.root.select(str(path)))
        finally:
            self._stack.pop()


def resolve(config: ConfigNode) -> ConfigNode:
    """Resolve all ``${...}`` interpolations/resolvers in place."""
    _Resolver(config).resolve_value(config)
    return config


# -- composition ---------------------------------------------------------

def compose(
    config_dir: str | Path,
    config_name: str = "config",
    overrides: list[str] | None = None,
    *,
    do_resolve: bool = True,
) -> ConfigNode:
    """Hydra-style compose: base YAML + optional experiment overlay + CLI
    overrides, then interpolation resolution.

    Mirrors the reference entry points' ``@hydra.main(config_path=...,
    config_name="config")`` behavior (reference: ``src/train.py:72``).
    """
    config_dir = Path(config_dir)
    with open(config_dir / f"{config_name}.yaml") as f:
        raw = _yaml_load(f) or {}

    defaults = raw.pop("defaults", ["_self_"])
    raw.pop("hydra", None)
    config = ConfigNode(raw)

    overrides = list(overrides or [])
    experiment = None
    passthrough: list[tuple[str, str, bool]] = []
    for ov in overrides:
        additive = ov.startswith("+")
        key, _, val = ov.lstrip("+").partition("=")
        if key in ("experiment",):
            experiment = val if val != "null" else None
        else:
            passthrough.append((key, val, additive))

    # defaults list: entries before _self_ would be merged first; the
    # reference uses [_self_, optional experiment: null] so the experiment
    # overlay wins over the base config.
    for entry in defaults:
        if entry == "_self_":
            continue
        if isinstance(entry, dict):
            [(group, name)] = entry.items()
            group = group.replace("optional ", "")
            name = experiment if group == "experiment" else name
            if name is None:
                continue
            path = config_dir / group / f"{name}.yaml"
            with open(path) as f:
                text = f.read()
            overlay_raw = _yaml_load(text) or {}
            overlay_raw.pop("defaults", None)
            overlay_raw.pop("hydra", None)
            # '# @package _global_' overlays merge at root (the only mode
            # the reference uses).
            _merge(config, ConfigNode(overlay_raw))

    for key, val, additive in passthrough:
        config.update_path(key, _parse_scalar(val), allow_new=True)

    if do_resolve:
        resolve(config)
    return config


def save_config(config: ConfigNode, path: str | Path) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(config.to_dict(), f, sort_keys=False)


def load_config(path: str | Path) -> ConfigNode:
    with open(path) as f:
        return ConfigNode(_yaml_load(f) or {})
