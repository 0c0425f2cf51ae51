"""Hydra-compatible config layer for the PyTorch port (no hydra dependency).

A copy of the JAX package's ``config/core.py`` (YAML composition with a
``defaults:`` list, dotlist overrides, ``${a.b}`` interpolation,
``instantiate`` on ``_target_`` strings, the ``@main`` driver decorator),
reading the same YAML files under ``configs/``.

The YAML files name the JAX package's classes in their ``_target_``
strings. ``instantiate`` rewrites that package prefix onto this package, so
``<jax package>.models.zoo.DINO`` builds ``midvision_probe_torch.models.zoo.DINO``.
The reference's own YAMLs name ``evals.X`` (``evals.models.dino.DINO``);
those resolve to ``midvision_probe_torch.compat.X``, which holds the port's
classes under the reference's paths. A target without a counterpart in the
port raises a clear error instead of reaching back into the JAX package.
The mapping is local to this module:
no process-global alias table is touched.
"""

from __future__ import annotations

import copy
import functools
import importlib
import os
import re
import sys
from typing import Any, Callable, Iterable, Mapping

import yaml

# the one place the port names the JAX package: the prefix of the
# `_target_` strings in configs/*.yaml, rewritten onto this package
_JAX_TARGET_PREFIX = "midvision_probe_tpu."
_PORT_PREFIX = "midvision_probe_torch."
# the reference's `_target_` prefix (`evals.models.dino.DINO`), rewritten
# onto `compat/`, which holds the port's classes under those paths
_REFERENCE_PREFIX = "evals."
_COMPAT = "midvision_probe_torch.compat"
JAX_PACKAGE = _JAX_TARGET_PREFIX.rstrip(".")  # for reports that cite its files


class Config(dict):
    """A nested dict with attribute access (stand-in for OmegaConf DictConfig)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node


def _wrap(obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return Config({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def default_config_dir() -> str:
    env = os.environ.get("MVP_CONFIG_DIR")
    if env:
        return env
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "configs")


class _Yaml12Loader(yaml.SafeLoader):
    """SafeLoader with YAML-1.2 float resolution: PyYAML's 1.1 resolver
    requires a '.' so ``1e-4`` would parse as a string."""


_Yaml12Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |[-+]?\.[0-9_]+(?:[eE][-+]?[0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        data = yaml.load(f, Loader=_Yaml12Loader)
    return data or {}


def _parse_value(text: str) -> Any:
    """Parse an override value the way OmegaConf's dotlist does (YAML scalar)."""
    try:
        return yaml.load(text, Loader=_Yaml12Loader)
    except yaml.YAMLError:
        return text


def _set_path(cfg: dict, dotted: str, value: Any, allow_new: bool) -> None:
    parts = dotted.split(".")
    node = cfg
    for part in parts[:-1]:
        if part not in node or not isinstance(node[part], dict):
            if not allow_new:
                raise KeyError(
                    f"Override path '{dotted}' not in config (use +{dotted}=... to add)"
                )
            node[part] = Config()
        node = node[part]
    if parts[-1] not in node and not allow_new:
        raise KeyError(
            f"Override key '{dotted}' not in config (use +{dotted}=... to add)"
        )
    node[parts[-1]] = value


_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _resolve_interpolations(cfg: Config) -> None:
    def resolve(value: Any) -> Any:
        if isinstance(value, str):
            full = _INTERP_RE.fullmatch(value)
            if full:
                target = cfg.get_path(full.group(1))
                if target is None:
                    raise KeyError(f"Interpolation '{value}' not resolvable")
                return resolve(target)
            return _INTERP_RE.sub(
                lambda m: str(cfg.get_path(m.group(1), m.group(0))), value
            )
        return value

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            for k in list(node.keys()):
                node[k] = walk(node[k])
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        return resolve(node)

    walk(cfg)


def compose(
    config_name: str,
    overrides: Iterable[str] = (),
    config_dir: str | None = None,
) -> Config:
    """Compose an experiment config like ``hydra.compose``.

    ``group=name`` swaps a group file, dotted overrides set leaf values and
    a ``+`` prefix adds new keys (``+system.device=cpu``) or a new group.
    """
    config_dir = config_dir or default_config_dir()
    top = _load_yaml(os.path.join(config_dir, config_name + ".yaml"))

    defaults = top.pop("defaults", [])
    group_choices: dict[str, str] = {}
    group_order: list[str] = []
    for entry in defaults:
        if isinstance(entry, Mapping):
            ((group, name),) = entry.items()
            group_choices[str(group)] = str(name)
            group_order.append(str(group))

    dotlist: list[tuple[str, Any, bool]] = []
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        allow_new = ov.startswith("+")
        body = ov[1:] if allow_new else ov
        if "=" not in body:
            raise ValueError(f"Override '{ov}' must be key=value")
        key, _, raw = body.partition("=")
        key = key.strip()
        if key in group_choices and "." not in key:
            group_choices[key] = raw.strip()
        elif (allow_new and "." not in key
              and os.path.isfile(os.path.join(config_dir, key,
                                              raw.strip() + ".yaml"))):
            group_choices[key] = raw.strip()
            group_order.append(key)
        else:
            dotlist.append((key, _parse_value(raw.strip()), allow_new))

    cfg = Config()
    for group in group_order:
        gpath = os.path.join(config_dir, group, group_choices[group] + ".yaml")
        cfg[group] = _wrap(_load_yaml(gpath))
    _deep_merge(cfg, _wrap(top))  # _self_ merges last

    for key, value, allow_new in dotlist:
        _set_path(cfg, key, _wrap(value), allow_new)

    _resolve_interpolations(cfg)
    return cfg


def _deep_merge(dst: dict, src: Mapping) -> dict:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, Mapping):
            _deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _locate(target: str) -> Any:
    ported = target
    if target.startswith(_JAX_TARGET_PREFIX):
        ported = _PORT_PREFIX + target[len(_JAX_TARGET_PREFIX):]
    elif target.startswith(_REFERENCE_PREFIX):  # the reference's own YAMLs
        importlib.import_module(_COMPAT)
        ported = f"{_COMPAT}.{target[len(_REFERENCE_PREFIX):]}"
    module_name, _, attr = ported.rpartition(".")
    if not module_name.startswith(_PORT_PREFIX):
        raise ImportError(
            f"config target '{target}' is outside the PyTorch port; only "
            "targets of the JAX package (rewritten onto this package) are "
            "supported")
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as e:
        raise NotImplementedError(
            f"config target '{target}' has no counterpart in the PyTorch port "
            f"yet (no module {module_name})") from e
    if not hasattr(module, attr):
        raise NotImplementedError(
            f"config target '{target}' has no counterpart in the PyTorch port "
            f"yet ({module_name} has no '{attr}'; ROADMAP.md section 1 lists "
            "what is left)")
    return getattr(module, attr)


def instantiate(cfg: Any, *args: Any, **kwargs: Any) -> Any:
    """Build an object from a ``_target_`` config node (hydra.utils.instantiate).

    Nested dict values holding their own ``_target_`` are instantiated
    recursively; ``**kwargs`` override config keys."""
    if not isinstance(cfg, Mapping) or "_target_" not in cfg:
        raise TypeError(f"instantiate() needs a mapping with _target_, got {cfg!r}")
    target = _locate(cfg["_target_"])
    call_kwargs: dict[str, Any] = {}
    for k, v in cfg.items():
        if k.startswith("_"):
            continue
        if isinstance(v, Mapping) and "_target_" in v:
            call_kwargs[k] = instantiate(v)
        else:
            call_kwargs[k] = v
    call_kwargs.update(kwargs)
    return target(*args, **call_kwargs)


def main(config_name: str, config_dir: str | None = None) -> Callable:
    """Driver decorator replacing ``@hydra.main``: parses ``sys.argv[1:]``
    (or ``argv``) as overrides and calls the wrapped function with the
    composed config."""

    def decorator(fn: Callable[[Config], Any]) -> Callable[..., Any]:
        @functools.wraps(fn)
        def wrapper(argv: list[str] | None = None) -> Any:
            overrides = sys.argv[1:] if argv is None else argv
            return fn(compose(config_name, overrides, config_dir))

        return wrapper

    return decorator
