"""Command-line flag parsing — the JAX package's ``utils/flags.py``.

Capability parity with the reference's vendored libfm ``CMDLine``
(``src/utils/CMDLine.h:29-197``): ``-key value`` pairs, registered help text,
typed getters with defaults, list values split on ``;`` or ``,``. Unknown flags
are fatal when help is registered (``CMDLine.h`` check in ``parse``).

Reference binaries take ``-config <file>`` (``src/tools/run_master.sh``) and
workers additionally ``-data <file>`` (``src/tools/run_worker.sh``);
:func:`parse_role_argv` reproduces that entry contract and folds flags into the
global config so flag and file configuration share one surface.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence

from swiftsnails_tpu_torch.utils.config import Config, ConfigError, global_config, load_config


class CmdLine:
    """``-key value`` argv parser with registered help (``CMDLine.h:29-197``)."""

    def __init__(self) -> None:
        self._help: Dict[str, str] = {}
        self._values: Dict[str, str] = {}

    def register_help(self, key: str, text: str) -> None:
        self._help[key] = text

    @staticmethod
    def _is_flag(tok: str) -> bool:
        # "-0.5" / "-3" are values, not flags
        if not tok.startswith("-") or tok == "-":
            return False
        body = tok.lstrip("-")
        try:
            float(body)
            return False
        except ValueError:
            return True

    def parse(self, argv: Sequence[str]) -> None:
        i = 0
        args = list(argv)
        while i < len(args):
            tok = args[i]
            if not self._is_flag(tok):
                raise ConfigError(f"expected -flag, got {tok!r}")
            key = tok.lstrip("-")
            if self._help and key not in self._help and key != "help":
                raise ConfigError(f"unknown flag -{key}; known: {sorted(self._help)}")
            if i + 1 < len(args) and not self._is_flag(args[i + 1]):
                self._values[key] = args[i + 1]
                i += 2
            else:
                self._values[key] = ""
                i += 1

    def has(self, key: str) -> bool:
        return key in self._values

    def get_str(self, key: str, default: Optional[str] = None) -> str:
        if key not in self._values:
            if default is None:
                raise ConfigError(f"missing flag -{key}")
            return default
        return self._values[key]

    def get_int(self, key: str, default: Optional[int] = None) -> int:
        if key not in self._values and default is not None:
            return default
        return int(self.get_str(key), 0)

    def get_float(self, key: str, default: Optional[float] = None) -> float:
        if key not in self._values and default is not None:
            return default
        return float(self.get_str(key))

    def get_list(self, key: str, default: Optional[List[str]] = None) -> List[str]:
        """Split on ``;`` and ``,`` like libfm (``CMDLine.h`` list values)."""
        if key not in self._values and default is not None:
            return default
        raw = self.get_str(key)
        out: List[str] = []
        for part in raw.replace(";", ",").split(","):
            part = part.strip()
            if part:
                out.append(part)
        return out

    def help_text(self) -> str:
        width = max((len(k) for k in self._help), default=0)
        return "\n".join(f"  -{k.ljust(width)}  {v}" for k, v in sorted(self._help.items()))

    def values(self) -> Dict[str, str]:
        return dict(self._values)


def parse_role_argv(argv: Optional[Sequence[str]] = None) -> Config:
    """Entry-point contract: ``-config <file>`` plus ``-key value`` overrides.

    Replaces the contents of :func:`global_config` with the config file (if
    given), then lays any remaining flags on top, and returns the global
    config. A second call in one process starts from an empty config, so no
    key of an earlier command line carries over (the JAX package's version
    merges into what the global config already holds).
    """
    if argv is None:
        argv = sys.argv[1:]
    cmd = CmdLine()
    cmd.parse(argv)
    cfg = global_config()
    cfg.clear()
    if cmd.has("config"):
        cfg.update(load_config(cmd.get_str("config")))
    for key, value in cmd.values().items():
        if key != "config":
            cfg.set(key, value)
    return cfg
