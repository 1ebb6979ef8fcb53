"""Findings, suppressions, and rendering for the static passes.

One :class:`Finding` per problem, pinned to ``path:line``.  Suppression
is inline and must be justified::

    something_flagged()  # analysis: ignore[wall-clock] -- live frontend epoch

A suppression without the ``-- <justification>`` tail does not silence
anything — it produces a ``bad-suppression`` finding of its own, so the
escape hatch cannot rot into a blanket mute.
"""

from __future__ import annotations

import json
import re
from dataclasses import asdict, dataclass

__all__ = ["Finding", "Suppressions", "render_text", "render_json"]

_IGNORE_RE = re.compile(
    r"#\s*analysis:\s*ignore\[(?P<rules>[\w,\- ]+)\]"
    r"(?:\s*--\s*(?P<reason>\S.*))?")

#: marker for methods entered with the instance lock already held
CALLER_LOCKS_RE = re.compile(r"#\s*analysis:\s*caller-locks\b")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Suppressions:
    """Per-file inline suppression table (line → justified rule set)."""

    def __init__(self, path: str, source_lines: list[str]) -> None:
        self.path = path
        self._by_line: dict[int, set[str]] = {}
        self.bad: list[Finding] = []
        for i, text in enumerate(source_lines, start=1):
            m = _IGNORE_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",")
                     if r.strip()}
            if not m.group("reason"):
                self.bad.append(Finding(
                    rule="bad-suppression", path=path, line=i,
                    message="suppression without justification: write "
                            "`# analysis: ignore[rule] -- <why>`"))
                continue
            self._by_line[i] = rules

    def allows(self, finding: Finding) -> bool:
        rules = self._by_line.get(finding.line)
        return rules is not None and finding.rule in rules

    def apply(self, findings: list[Finding]) -> list[Finding]:
        """Filter suppressed findings; unjustified suppressions are
        appended as findings themselves."""
        kept = [f for f in findings if not self.allows(f)]
        kept.extend(self.bad)
        return kept


def render_text(findings: list[Finding], checked_files: int) -> str:
    lines = [f.render() for f in sorted(
        findings, key=lambda f: (f.path, f.line, f.rule))]
    if findings:
        lines.append(f"\n{len(findings)} finding(s) in "
                     f"{checked_files} file(s) analyzed")
    else:
        lines.append(f"clean: 0 findings in {checked_files} file(s) "
                     "analyzed")
    return "\n".join(lines)


def render_json(findings: list[Finding], checked_files: int) -> str:
    return json.dumps({
        "files_analyzed": checked_files,
        "findings": [asdict(f) for f in sorted(
            findings, key=lambda f: (f.path, f.line, f.rule))],
    }, indent=1)
