"""Typed ``key: value`` configuration with recursive ``import``.

Capability parity with the reference ConfigParser
(``src/utils/ConfigParser.h:25-129``):

* one ``key: value`` pair per line, ``#`` starts a comment;
* blank lines ignored;
* ``import <path>`` recursively loads another config file (relative paths
  resolve against the importing file's directory — the reference resolves
  against the process cwd, ``ConfigParser.h:100-105``; we keep a cwd fallback);
* typed getters ``to_int32 / to_float / to_string / to_bool``
  (``ConfigParser.h:31-47``);
* missing keys raise (the reference CHECK-crashes at ``get_config``,
  ``ConfigParser.h:71-75``);
* a process-wide singleton ``global_config()`` (``ConfigParser.h:126-129``).

Unlike the reference, values can also be set programmatically and the parser
supports ``key = value`` (both separators), making it usable as the single
config surface for CLI overrides.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterator, List, Optional, Tuple, Union


class ConfigError(Exception):
    """Raised for malformed config files or missing keys."""


_TRUE_WORDS = {"1", "true", "yes", "on"}
_FALSE_WORDS = {"0", "false", "no", "off"}


class Item:
    """A single config value with typed accessors (``ConfigParser.h:27-50``)."""

    __slots__ = ("value",)

    def __init__(self, value: str = ""):
        self.value = value

    def to_string(self) -> str:
        return self.value

    def to_int32(self) -> int:
        try:
            return int(self.value, 0)
        except ValueError as e:
            raise ConfigError(f"config value {self.value!r} is not an int") from e

    def to_float(self) -> float:
        try:
            return float(self.value)
        except ValueError as e:
            raise ConfigError(f"config value {self.value!r} is not a float") from e

    def to_bool(self) -> bool:
        word = self.value.strip().lower()
        if word in _TRUE_WORDS:
            return True
        if word in _FALSE_WORDS:
            return False
        raise ConfigError(f"config value {self.value!r} is not a bool")

    def __repr__(self) -> str:
        return f"Item({self.value!r})"


class Config:
    """An ordered ``key -> Item`` table loadable from files.

    The reference keeps a flat unordered_map (``ConfigParser.h:118-121``);
    we keep insertion order so round-trip dumps are stable.
    """

    def __init__(self, values: Optional[Dict[str, str]] = None):
        self._items: Dict[str, Item] = {}
        if values:
            for k, v in values.items():
                self.set(k, v)

    # -- loading ----------------------------------------------------------

    def load(self, path: Union[str, os.PathLike], _seen: Optional[set] = None) -> "Config":
        """Parse ``path``, following ``import`` lines recursively."""
        path = os.fspath(path)
        seen = _seen if _seen is not None else set()
        real = os.path.realpath(path)
        if real in seen:
            raise ConfigError(f"config import cycle at {path}")
        seen.add(real)
        try:
            with open(path, "r", encoding="utf-8") as f:
                lines = f.readlines()
        except OSError as e:
            raise ConfigError(f"cannot open config file {path}: {e}") from e
        for lineno, raw in enumerate(lines, 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if line.startswith("import ") or line == "import":
                target = line[len("import"):].strip()
                if not target:
                    raise ConfigError(f"{path}:{lineno}: empty import")
                cand = target
                if not os.path.isabs(cand):
                    rel = os.path.join(os.path.dirname(path), target)
                    cand = rel if os.path.exists(rel) else target
                self.load(cand, _seen=seen)
                continue
            key, sep, value = self._split_kv(line)
            if not sep:
                raise ConfigError(f"{path}:{lineno}: expected 'key: value', got {line!r}")
            self.set(key, value)
        return self

    @staticmethod
    def _split_kv(line: str) -> Tuple[str, str, str]:
        # Accept both "key: value" (reference syntax) and "key = value",
        # splitting at whichever separator appears first so values may
        # contain the other character (e.g. "data = hdfs://x").
        found = [(line.find(sep), sep) for sep in (":", "=") if sep in line]
        if not found:
            return line, "", ""
        i, sep = min(found)
        return line[:i].strip(), sep, line[i + 1 :].strip()

    # -- access -----------------------------------------------------------

    def set(self, key: str, value) -> None:
        self._items[key] = Item(str(value))

    def update(self, other: Union["Config", Dict[str, str]]) -> None:
        if isinstance(other, Config):
            for k, item in other._items.items():
                self.set(k, item.value)
        else:
            for k, v in other.items():
                self.set(k, v)

    def get(self, key: str) -> Item:
        """Reference ``get_config``: missing key is fatal (``ConfigParser.h:71-75``)."""
        try:
            return self._items[key]
        except KeyError:
            raise ConfigError(f"missing config key {key!r}") from None

    def get_int(self, key: str, default: Optional[int] = None) -> int:
        if default is not None and key not in self:
            return default
        return self.get(key).to_int32()

    def get_float(self, key: str, default: Optional[float] = None) -> float:
        if default is not None and key not in self:
            return default
        return self.get(key).to_float()

    def get_str(self, key: str, default: Optional[str] = None) -> str:
        if default is not None and key not in self:
            return default
        return self.get(key).to_string()

    def get_bool(self, key: str, default: Optional[bool] = None) -> bool:
        if default is not None and key not in self:
            return default
        return self.get(key).to_bool()

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def keys(self) -> List[str]:
        return list(self._items)

    def as_dict(self) -> Dict[str, str]:
        return {k: v.value for k, v in self._items.items()}

    def clear(self) -> None:
        self._items.clear()

    def dumps(self) -> str:
        return "\n".join(f"{k}: {v.value}" for k, v in self._items.items())

    def __repr__(self) -> str:
        return f"Config({self.as_dict()!r})"


def load_config(path: Union[str, os.PathLike]) -> Config:
    return Config().load(path)


_global_config: Optional[Config] = None
_global_lock = threading.Lock()


def global_config() -> Config:
    """Process-wide singleton (reference ``global_config()``, ``ConfigParser.h:126-129``)."""
    global _global_config
    if _global_config is None:
        with _global_lock:
            if _global_config is None:
                _global_config = Config()
    return _global_config
