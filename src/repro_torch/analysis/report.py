"""Shared reporting types for the `repro_torch.analysis` checkers.

The port's own copy of `repro/analysis/report.py`.

A checker produces a list of `Violation`s; the CLI formats them as
``file:line: [checker/kind] qualname: detail`` so editors and CI logs
can jump straight to the site.  Paths are repo-relative.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List


def repo_root() -> Path:
    """The repository root (this file lives at src/repro_torch/analysis/)."""
    return Path(__file__).resolve().parents[3]


def rel(path) -> str:
    """``path`` repo-relative when possible, as a posix string."""
    p = Path(path).resolve()
    try:
        return p.relative_to(repo_root()).as_posix()
    except ValueError:
        return p.as_posix()


@dataclasses.dataclass(frozen=True)
class Violation:
    """One diagnosed invariant break.

    checker   which checker produced it (lint/hostsync/retrace/donation)
    kind      the violation class within that checker (e.g. "branch",
              "host-coercion", "rng-draw", "retrace", "copying-write")
    file      repo-relative path of the offending site
    line      1-based line number
    qualname  enclosing function/method (or audit site name)
    detail    one-line human diagnosis (source snippet, counts, bytes)
    """
    checker: str
    kind: str
    file: str
    line: int
    qualname: str
    detail: str

    def __str__(self) -> str:
        return (f"{self.file}:{self.line}: [{self.checker}/{self.kind}] "
                f"{self.qualname}: {self.detail}")


def render(violations: List[Violation]) -> str:
    return "\n".join(str(v) for v in sorted(
        violations, key=lambda v: (v.file, v.line, v.kind)))
