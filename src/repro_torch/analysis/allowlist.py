"""The checker allowlist: sanctioned exceptions, one per line, with a
mandatory reason.

The port's own copy of `repro/analysis/allowlist.py`; the port's entries
live in its own ``allowlist.txt`` beside this module.

Format (``allowlist.txt`` next to this module)::

    <file>::<qualname>::<kind>::<detail-substring>  # <reason>

``file`` is repo-relative; ``qualname`` and ``kind`` match exactly or
are ``*``; ``detail-substring`` must occur in the violation's detail
(``*`` matches anything).  A line with no ``# reason`` is a parse
error — an exception nobody can justify is not an exception.

Matching is deliberately narrow: an entry keyed on file+qualname+kind
cannot blanket-silence a checker, and `unused_entries` lets the lint
fail on entries that no longer match anything, so the allowlist shrinks
when the code it excuses is fixed.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Tuple

from repro_torch.analysis.report import Violation, rel

DEFAULT_PATH = Path(__file__).with_name("allowlist.txt")


@dataclasses.dataclass(frozen=True)
class Entry:
    file: str
    qualname: str
    kind: str
    substring: str
    reason: str
    lineno: int

    def matches(self, v: Violation) -> bool:
        return (self.file == v.file
                and self.qualname in ("*", v.qualname)
                and self.kind in ("*", v.kind)
                and (self.substring == "*" or self.substring in v.detail))


def load(path=None) -> List[Entry]:
    path = Path(path) if path is not None else DEFAULT_PATH
    entries: List[Entry] = []
    for lineno, raw in enumerate(path.read_text().splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        body, sep, reason = line.partition("#")
        reason = reason.strip()
        if not sep or not reason:
            raise ValueError(
                f"{path}:{lineno}: allowlist entry has no '# reason' — "
                f"every sanctioned exception must say why: {raw!r}")
        parts = [p.strip() for p in body.strip().split("::")]
        if len(parts) != 4 or not all(parts):
            raise ValueError(
                f"{path}:{lineno}: expected "
                f"'file::qualname::kind::substring  # reason', got {raw!r}")
        entries.append(Entry(*parts, reason=reason, lineno=lineno))
    return entries


def apply(violations: List[Violation], entries: List[Entry]
          ) -> Tuple[List[Violation], List[Entry]]:
    """(violations not excused, entries that excused at least one)."""
    used = set()
    kept = []
    for v in violations:
        hit = next((e for e in entries if e.matches(v)), None)
        if hit is None:
            kept.append(v)
        else:
            used.add(id(hit))
    return kept, [e for e in entries if id(e) in used]


def unused_entries(entries: List[Entry], used: List[Entry],
                   path=None) -> List[Violation]:
    """Stale allowlist entries, reported as violations themselves."""
    path = Path(path) if path is not None else DEFAULT_PATH
    used_ids = {id(e) for e in used}
    return [
        Violation(checker="lint", kind="stale-allowlist",
                  file=rel(path), line=e.lineno, qualname=e.qualname,
                  detail=(f"entry excuses nothing any more "
                          f"({e.file}::{e.qualname}::{e.kind}) — "
                          f"delete it"))
        for e in entries if id(e) not in used_ids]
