"""The finding record the port's checkers share (the port's copy of
``Finding`` from the JAX package's ``analysis/core.py``), and their exit
codes.

The reference's AST project walk (gridlint) is not here: the tools that
use this module (``tools.storecheck``, ``tools.incident_demo``,
``tools.attribution``) only report findings.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# the exit-code convention of every checker CLI
EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str  # repo-relative, posix separators
    line: int
    col: int
    message: str
    symbol: str = ""  # enclosing function qualname, "" at module level

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def baseline_key(self) -> Tuple[str, str, str, str]:
        """Line-number-insensitive identity used for baseline matching:
        edits above a grandfathered finding must not un-baseline it."""
        return (self.rule, self.path, self.symbol, self.message)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{loc}: {self.rule}{sym}: {self.message}"


def exit_code(findings) -> int:
    """0 when ``findings`` is empty, else 1 (2 is a usage error, which
    argparse and the tools raise themselves)."""
    return EXIT_FINDINGS if findings else EXIT_CLEAN
