"""``--config-file`` for the launcher: the port's own copy of the JAX
package's ``runner/config_parser.py`` (Horovod's
``common/util/config_parser.py``), limited to the launcher's flags. Every
flag can come from a YAML (or JSON) mapping; explicit CLI flags win over
the file's values."""

from __future__ import annotations

import argparse
from typing import Optional

# YAML key → argparse dest
_KEYS = {
    "verbose": "verbose",
    "master-port": "master_port",
    "ssh-port": "ssh_port",
}


def load_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"config file {path} must be a YAML mapping")
    unknown = [k for k in data if k not in _KEYS]
    if unknown:
        raise ValueError(
            f"unknown config keys {unknown}; valid: {sorted(_KEYS)}")
    return {_KEYS[k]: v for k, v in data.items()}


def apply_config(args: argparse.Namespace, path: Optional[str],
                 parser: argparse.ArgumentParser) -> argparse.Namespace:
    """Fill args from the file, but only where the CLI left the parser's
    default (explicit flags always win)."""
    if not path:
        return args
    for dest, value in load_config(path).items():
        if getattr(args, dest, None) == parser.get_default(dest):
            setattr(args, dest, value)
    return args
