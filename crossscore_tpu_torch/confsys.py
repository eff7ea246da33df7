"""Hydra-style configuration system: YAML composition + dotted CLI overrides;
the port's own copy of ``crossscore_tpu/confsys.py``, reading the port's YAML
tree (``crossscore_tpu_torch/config/``).

The reference stack uses Hydra 1.3 (reference ``task/train.py:26``,
``config/default.yaml:1-4``) with a ``defaults: [_self_, data: <x>, model: model]``
composition list and ``a.b.c=value`` command-line overrides. Hydra/omegaconf are
not available in this environment, so this module implements the same UX on top
of PyYAML:

- :func:`load_config` composes a root YAML with its ``defaults`` list (group
  entries like ``data: combined_training`` load ``config/data/combined_training.yaml``
  into ``cfg.data``), then applies dotted overrides.
- :class:`Config` is a dict with recursive attribute access, so ``cfg.model.patch_size``
  works like an OmegaConf DictConfig.

Override syntax: ``key.sub=value`` where value is parsed with YAML semantics
(``null``, ``true``, ints, floats, ``[a,b]`` lists, bare strings). A ``+key=value``
prefix adds a new key (plain overrides of unknown keys raise, same as Hydra).
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Iterable, Mapping

import yaml

_CONFIG_DIR = Path(__file__).parent / "config"


class _Loader(yaml.SafeLoader):
    """SafeLoader with a YAML-1.2-style float resolver so ``5e-4`` parses as a
    float (plain YAML 1.1 requires ``5.0e-4``)."""


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _yaml_load(text: str):
    return yaml.load(text, Loader=_Loader)


class Config(dict):
    """Dict with recursive attribute access (OmegaConf-DictConfig-alike)."""

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

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def from_nested(obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return Config({k: Config.from_nested(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.from_nested(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        def conv(obj):
            if isinstance(obj, Mapping):
                return {k: conv(v) for k, v in obj.items()}
            if isinstance(obj, list):
                return [conv(v) for v in obj]
            return obj

        return conv(self)


def _deep_merge(base: dict, extra: Mapping) -> dict:
    """Merge ``extra`` into ``base`` recursively (extra wins), returning base."""
    for k, v in extra.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, Mapping):
            _deep_merge(base[k], v)
        else:
            base[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v
    return base


def _read_yaml(path: Path) -> dict:
    with open(path, "r") as f:
        doc = _yaml_load(f.read())
    return doc or {}


def load_config(
    name: str,
    overrides: Iterable[str] = (),
    config_dir: str | Path | None = None,
) -> Config:
    """Compose the root config ``<config_dir>/<name>.yaml`` and apply overrides.

    Mirrors Hydra's composition-order semantics for the reference's configs
    (reference ``config/default.yaml:1-4``): entries in the ``defaults`` list are
    merged in order; ``_self_`` stands for the root file's own content.
    """
    config_dir = Path(config_dir) if config_dir is not None else _CONFIG_DIR
    root_path = config_dir / f"{name}.yaml"
    root_doc = _read_yaml(root_path)

    defaults = root_doc.pop("defaults", ["_self_"])
    root_doc.pop("hydra", None)  # run-dir management is handled by the tasks

    # hydra-style group selection from the CLI: ``data=mip360`` swaps the
    # defaults-list choice for that group (reference usage:
    # ``python task/train.py data=combined_testing``)
    overrides = list(overrides)
    group_choices: dict[str, str] = {}
    plain_overrides = []
    for ov in overrides:
        key, _, raw = ov.partition("=")
        if "=" in ov and "." not in key and not key.startswith("+") and (config_dir / key).is_dir():
            if not (config_dir / key / f"{raw}.yaml").exists():
                available = sorted(p.stem for p in (config_dir / key).glob("*.yaml"))
                raise FileNotFoundError(
                    f"Unknown {key} group choice {raw!r}; available: {available}"
                )
            group_choices[key] = raw
        else:
            plain_overrides.append(ov)

    merged: dict = {}
    for entry in defaults:
        if entry == "_self_":
            _deep_merge(merged, root_doc)
        elif isinstance(entry, Mapping):
            for group, choice in entry.items():
                group = str(group)
                if group.startswith("override "):
                    continue  # hydra logging toggles: not applicable
                choice = group_choices.pop(group, choice)
                group_doc = _read_yaml(config_dir / group / f"{choice}.yaml")
                _deep_merge(merged, {group: group_doc})
        else:
            # bare include of a sibling yaml file
            _deep_merge(merged, _read_yaml(config_dir / f"{entry}.yaml"))
    # group selections for groups not in the defaults list
    for group, choice in group_choices.items():
        _deep_merge(merged, {group: _read_yaml(config_dir / group / f"{choice}.yaml")})

    cfg = Config.from_nested(merged)
    apply_overrides(cfg, plain_overrides)
    return cfg


def parse_value(text: str) -> Any:
    """Parse an override value with YAML scalar semantics."""
    try:
        return _yaml_load(text)
    except yaml.YAMLError:
        return text


def apply_overrides(cfg: Config, overrides: Iterable[str]) -> Config:
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override {ov!r} must look like key.sub=value")
        key, _, raw = ov.partition("=")
        allow_new = key.startswith("+")
        key = key.lstrip("+")
        parts = key.split(".")
        node: Any = cfg
        for part in parts[:-1]:
            if part not in node:
                if not allow_new:
                    raise KeyError(f"Unknown config group {part!r} in override {ov!r}")
                node[part] = Config()
            node = node[part]
            if not isinstance(node, Mapping):
                raise KeyError(f"Cannot override through non-dict node {part!r} in {ov!r}")
        leaf = parts[-1]
        if leaf not in node and not allow_new:
            raise KeyError(
                f"Unknown config key {key!r} in override {ov!r} (prefix with '+' to add)"
            )
        value = parse_value(raw)
        node[leaf] = Config.from_nested(value) if isinstance(value, Mapping) else value
    return cfg
