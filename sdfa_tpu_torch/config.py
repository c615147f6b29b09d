"""Hierarchical config tree and ``configure`` (counterpart of
``sdfa_tpu/utils/config.py`` + ``sdfa_tpu/tools.py::configure``).

Reads the same ``configs/`` tree as the JAX package: ``default.py`` →
model config → dataset config selected by ``dataset_anime.name`` →
overrides → ``{DATASET_ANIME_ROOT}`` substitution.
"""

from __future__ import annotations

import importlib.util
import os
import re
import warnings
from typing import Any, Dict, Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_ROOT = os.path.join(REPO_ROOT, "configs")

_ENTIRETY = "__entirety__"


class ConfigDict(dict):
    """A dict with attribute access and guarded mutation via ``set_key``."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        merged: Dict[str, Any] = {}
        for arg in args:
            if arg is None:
                continue
            if not isinstance(arg, dict):
                raise TypeError(f"ConfigDict positional args must be dicts, got {type(arg)}")
            merged.update(arg)
        merged.update(kwargs)
        for key, val in merged.items():
            super().__setitem__(str(key), self._wrap(val))

    @classmethod
    def _wrap(cls, val):
        if isinstance(val, ConfigDict):
            return val
        if isinstance(val, dict):
            return ConfigDict(val)
        if isinstance(val, (list, tuple)):
            return type(val)(cls._wrap(v) for v in val)
        return val

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(
                f"config key '{name}' not found; available keys: "
                f"{sorted(self.keys())}"
            ) from exc

    def __setattr__(self, name, value):
        raise AttributeError("ConfigDict is immutable via attribute set; use set_key()")

    def __setitem__(self, key, value):
        raise TypeError("ConfigDict is immutable via [] set; use set_key()")

    def set_key(self, key, value):
        super().__setitem__(str(key), self._wrap(value))

    def __reduce__(self):
        # dict-subclass pickling replays items through the (blocked)
        # __setitem__; rebuild through __init__ instead, so that a ConfigDict
        # crosses into the worker processes of data/prefetch.py
        return (ConfigDict, (dict(self),))

    def overwrite_by(self, other: Optional[dict]) -> "ConfigDict":
        """Recursive merge; a sub-dict with ``__entirety__: True`` replaces
        the whole subtree instead of merging."""
        if other is None:
            return self
        for key, val in other.items():
            if key == _ENTIRETY:
                continue
            if (isinstance(val, dict) and not val.get(_ENTIRETY, False)
                    and isinstance(self.get(key), ConfigDict)):
                self[key].overwrite_by(val)
            else:
                if isinstance(val, dict):
                    val = {k: v for k, v in val.items() if k != _ENTIRETY}
                self.set_key(key, val)
        return self

    def replace_variable(self, name: str, value) -> "ConfigDict":
        """Replace ``{NAME}`` markers in all string leaves."""
        marker = "{" + name + "}"

        def _sub(v):
            if isinstance(v, str) and marker in v:
                if v == marker and not isinstance(value, str):
                    return value
                return v.replace(marker, str(value))
            if isinstance(v, ConfigDict):
                for k2, v2 in list(v.items()):
                    v.set_key(k2, _sub(v2))
                return v
            if isinstance(v, (list, tuple)):
                return type(v)(_sub(x) for x in v)
            return v

        for k, v in list(self.items()):
            self.set_key(k, _sub(v))
        return self

    @staticmethod
    def parse_file(path: str) -> "ConfigDict":
        """Load hparams from a ``.py`` module exposing ``hparams``."""
        path = os.path.abspath(os.path.expanduser(path))
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        if os.path.splitext(path)[1] != ".py":
            raise ValueError(f"unsupported config file: {path}")
        spec = importlib.util.spec_from_file_location(
            "_sdfa_torch_config_" + re.sub(r"\W", "_", path), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        hp = getattr(module, "hparams", None)
        if hp is None:
            raise ValueError(f"config module {path} does not define `hparams`")
        return ConfigDict(hp)


def configure(custom_hparams: Optional[str] = None,
              overrides: Optional[dict] = None,
              dataset_root: Optional[str] = None) -> ConfigDict:
    """Assemble the resolved hparams tree (same resolution order as
    ``sdfa_tpu.tools.configure``; seeding is left to the caller, which
    passes explicit generators)."""
    hp = ConfigDict.parse_file(os.path.join(CONFIG_ROOT, "default.py"))
    if custom_hparams is not None:
        path = custom_hparams
        if not os.path.exists(path):
            for cand in (os.path.join(CONFIG_ROOT, path),
                         os.path.join(CONFIG_ROOT, "model", path),
                         os.path.join(CONFIG_ROOT, "model", path + ".py")):
                if os.path.exists(cand):
                    path = cand
                    break
        hp.overwrite_by(ConfigDict.parse_file(path))

    for ds_key in ("dataset_anime", "dataset_speech"):
        ds_name = (hp.get(ds_key) or {}).get("name")
        if not ds_name:
            continue
        ds_path = os.path.join(CONFIG_ROOT, "data", ds_name + ".py")
        if os.path.exists(ds_path):
            hp.overwrite_by(ConfigDict.parse_file(ds_path))
        else:
            warnings.warn(f"dataset config not found: {ds_path}")

    if overrides:
        hp.overwrite_by(overrides)

    root = dataset_root or hp.get("dataset_anime", {}).get("root", "")
    if root:
        root = os.path.abspath(os.path.expanduser(root))
        hp.replace_variable("DATASET_ANIME_ROOT", root)
        if "dataset_anime" in hp:
            hp.dataset_anime.set_key("root", root)
    return hp
