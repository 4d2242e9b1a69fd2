"""Configs as attribute-accessible nested dicts.

The JAX package reads its YAML configs into `Cfg` (rangeldm_tpu/utils/
config.py); this package takes the same nested dicts, built in Python or
read by the caller, and wraps them for dot access. `.get(key, default)`
mirrors the reference's `hasattr(args, ...)` feature gates
(ldm/train_unconditional.py:370-389).
"""

from __future__ import annotations

import copy
from typing import Any, Mapping


class Cfg(dict):
    """dict with attribute access and recursive wrapping."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return Cfg({k: Cfg.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(Cfg.wrap(v) for v in obj)
        return obj

    def merged(self, other: Mapping) -> "Cfg":
        """Deep merge: values in `other` win."""
        out = copy.deepcopy(dict(self))
        for k, v in other.items():
            if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
                out[k] = Cfg.wrap(out[k]).merged(v)
            else:
                out[k] = copy.deepcopy(v)
        return Cfg.wrap(out)
