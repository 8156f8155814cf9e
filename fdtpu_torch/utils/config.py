"""Hydra-style config composition (port of ``fdtpu/utils/config.py``).

The same grammar as the JAX package's: a root config whose ``defaults`` list
selects group files (``score_model: default`` →
``configs/score_model/default.yaml``), CLI overrides ``group=name`` (and a
nested group, ``score_model.noise_scheduler=vesde``), ``a.b=v`` on an
existing key, ``+a.b=v`` adding one, list indices in a path
(``metrics.metrics.0.num_directions=200``), and ``${a.b}`` interpolation.
An override's value is read as one YAML document, as ``yaml.safe_load``
reads it, except that a run-id-shaped token (``20260816_201855``) stays a
string.  YAML goes through :mod:`fdtpu_torch.utils.yaml_subset`: the machine
the port runs on has no PyYAML.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any

from fdtpu_torch.utils import yaml_subset

# The repository's configs, which the port's CLIs compose.
CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs"

_INTERP = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")
_RUN_ID = re.compile(r"\d{8}_\d{6}")


def _load_yaml(path: Path) -> dict[str, Any]:
    return yaml_subset.load(path) or {}


def parse_value(raw: str) -> Any:
    """An override's value (``fdtpu/utils/config.py:40-50``)."""
    value = yaml_subset.loads(raw)
    # YAML 1.1 reads digit groups with underscores as ints; a run id
    # (Trainer's strftime("%Y%m%d_%H%M%S")) stays the string it is.
    if isinstance(value, (int, float)) and _RUN_ID.fullmatch(raw):
        return raw
    return value


def _set_path(cfg: dict, dotted: str, value: Any, allow_new: bool) -> None:
    keys = dotted.split(".")
    node: Any = cfg
    for k in keys[:-1]:
        if isinstance(node, list):
            node = node[int(k)]
            continue
        if k not in node or not isinstance(node[k], (dict, list)):
            if not allow_new:
                raise KeyError(f"Unknown config path: {dotted}")
            node[k] = {}
        node = node[k]
    last = keys[-1]
    if isinstance(node, list):
        node[int(last)] = value
        return
    if last not in node and not allow_new:
        raise KeyError(f"Unknown config key: {dotted} (prefix with '+' to add new keys)")
    node[last] = value


def _get_path(cfg: dict, dotted: str) -> Any:
    node: Any = cfg
    for k in dotted.split("."):
        node = node[int(k)] if isinstance(node, list) else node[k]
    return node


def _resolve_interpolations(cfg: dict | list, root: dict) -> None:
    items = enumerate(cfg) if isinstance(cfg, list) else cfg.items()
    for k, v in list(items):
        if isinstance(v, (dict, list)):
            _resolve_interpolations(v, root)
        elif isinstance(v, str):
            m = _INTERP.match(v)
            if m:
                cfg[k] = _get_path(root, m.group(1))


def compose_config(
    config_dir: Path | str,
    config_name: str,
    overrides: list[str] | None = None,
) -> dict[str, Any]:
    """Compose ``<config_dir>/<config_name>.yaml`` with its defaults groups
    and apply the overrides."""
    config_dir = Path(config_dir)
    root = _load_yaml(config_dir / f"{config_name}.yaml")
    defaults = root.pop("defaults", [])

    group_choice: dict[str, str] = {}
    for entry in defaults:
        if entry == "_self_":
            continue
        if not (isinstance(entry, dict) and len(entry) == 1):
            raise ValueError(f"bad defaults entry {entry!r} in {config_name}.yaml")
        group, name = next(iter(entry.items()))
        group_choice[group] = name

    value_overrides: list[tuple[str, Any, bool]] = []
    subgroup_choice: dict[tuple[str, str], str] = {}
    for ov in overrides or []:
        allow_new = ov.startswith("+")
        key, _, raw = (ov[1:] if allow_new else ov).partition("=")
        if key in group_choice and "." not in key:
            group_choice[key] = raw
        elif key.count(".") == 1 and (config_dir / key.replace(".", "/") / f"{raw}.yaml").exists():
            group, sub_group = key.split(".")
            subgroup_choice[(group, sub_group)] = raw
        else:
            value_overrides.append((key, parse_value(raw), allow_new))

    for group, name in group_choice.items():
        group_cfg = _load_yaml(config_dir / group / f"{name}.yaml")
        for entry in group_cfg.pop("defaults", []):
            sub_group, sub_name = next(iter(entry.items()))
            sub_name = subgroup_choice.get((group, sub_group), sub_name)
            group_cfg[sub_group] = _load_yaml(config_dir / group / sub_group / f"{sub_name}.yaml")
        group_cfg["name"] = name
        root[group] = group_cfg

    for key, value, allow_new in value_overrides:
        _set_path(root, key, value, allow_new)

    _resolve_interpolations(root, root)
    return root


def split_config_name(argv: list[str], default: str) -> tuple[str, list[str]]:
    """``--config-name NAME`` or ``--config-name=NAME`` out of ``argv``
    (``cli/train.py:165-178``); returns ``(name, the other arguments)``."""
    name, rest, i = default, [], 0
    while i < len(argv):
        if argv[i] == "--config-name" and i + 1 < len(argv):
            name = argv[i + 1]
            i += 2
        elif argv[i].startswith("--config-name="):
            name = argv[i].split("=", 1)[1]
            i += 1
        else:
            rest.append(argv[i])
            i += 1
    return name, rest


def flatten_config(cfg: dict, prefix: str = "") -> dict[str, Any]:
    """Leaf keys of a nested config, for logging (later leaves win)."""
    flat: dict[str, Any] = {}
    for k, v in cfg.items():
        if isinstance(v, dict):
            flat.update(flatten_config(v))
        else:
            flat[k] = v
    return flat


def dict_to_str(d: dict[str, Any]) -> str:
    """One ``key : value`` line each, lists cut after three entries."""
    if not d:
        return ""
    max_len = max(len(str(k)) for k in d)
    lines = []
    for k, v in d.items():
        if isinstance(v, list) and len(v) > 3:
            v = v[:3] + ["..."]
        lines.append(f"\t {str(k): <{max_len + 5}} : \t  {v}")
    return "\n".join(lines)


def save_config(cfg: dict[str, Any], path: Path | str) -> None:
    yaml_subset.dump(cfg, path)


def load_config(path: Path | str) -> dict[str, Any]:
    return _load_yaml(Path(path))
