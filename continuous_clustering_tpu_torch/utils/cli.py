"""Minimal command-line parser (reference utils/command_line_parser.hpp); the
port's copy of ``continuous_clustering_tpu/utils/cli.py``."""

from __future__ import annotations

from typing import List


class CommandLineParser:
    def __init__(self, argv: List[str]):
        self._args = list(argv)

    def argument_exists(self, name: str) -> bool:
        if name in self._args:
            self._args.remove(name)
            return True
        return False

    def get_value_for_argument(self, name: str, default: str) -> str:
        if name in self._args:
            i = self._args.index(name)
            if i + 1 < len(self._args):
                value = self._args[i + 1]
                del self._args[i : i + 2]
                return value
            del self._args[i]
        return default

    def get_remaining_args(self) -> List[str]:
        return list(self._args)
