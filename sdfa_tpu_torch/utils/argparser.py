"""Mini argument DSL: mixed positional + ``"key=val"`` string args
(counterpart of ``sdfa_tpu/utils/argparser.py``, copied).

Same surface as the reference evaluate-source parser
(saber/utils/argparser.py:5-143): values in ``key=val`` strings
are JSON-coerced (with python-literal tolerance), positionals map onto a
declared arg list, abbreviations expand, and defaults fill in.
"""

from __future__ import annotations

import inspect
import json
from typing import Any, Dict, Iterable, List, Optional


def _coerce(val: str):
    if val in ("True", "true"):
        return True
    if val in ("False", "false"):
        return False
    if val in ("None", "null"):
        return None
    txt = val.replace("'", '"')
    try:
        return json.loads(txt)
    except ValueError:
        return val


def parse_named_arg(arg: str):
    key, _, val = arg.partition("=")
    if not _:
        raise ValueError(f"named arg should be <key>=<val>: {arg!r}")
    return key, _coerce(val)


class ArgumentParser(dict):
    """Parse ``("clip.mp4", "speaker=m1", ...)`` style argument tuples."""

    def __init__(
        self,
        *args,
        caller=None,
        all_args: Optional[List[str]] = None,
        defaults: Optional[Iterable[Any]] = None,
        key_abbrs: Optional[Dict[str, str]] = None,
    ):
        super().__init__()
        if caller is not None:
            if all_args is not None or defaults is not None:
                raise ValueError("pass either caller or all_args / defaults, not both")
            target = caller.__init__ if inspect.isclass(caller) else caller
            spec = inspect.getfullargspec(target)
            all_args = spec.args[1:] if inspect.isclass(caller) else spec.args
            defaults = spec.defaults
        defaults = list(defaults or [])
        key_abbrs = key_abbrs or {}
        n_essential = (len(all_args) - len(defaults)) if all_args else 0
        given = set()

        self.pos_args: List[Any] = []
        pos = 0
        for arg in args:
            if isinstance(arg, str) and "=" in arg:
                key, val = parse_named_arg(arg)
                key = key_abbrs.get(key, key)
                if key in self:
                    raise ValueError(f"duplicated key: {key}")
                super().__setitem__(key, val)
                given.add(key)
                pos = -1
            else:
                if pos < 0:
                    raise ValueError(f"positional arg {arg!r} after named args")
                self.pos_args.append(arg)
                if all_args is not None and pos < len(all_args):
                    super().__setitem__(all_args[pos], arg)
                    given.add(all_args[pos])
                pos += 1

        if all_args is not None:
            missing = [k for k in all_args[:n_essential] if k not in given]
            if missing:
                raise ValueError(f"required args not given: {missing}")
            for i, default in enumerate(defaults):
                key = all_args[n_essential + i]
                if key not in self:
                    super().__setitem__(key, default)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.pos_args[key] if 0 <= key < len(self.pos_args) else None
        return super().get(key)
