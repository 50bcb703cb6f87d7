"""simlint core for the port — findings, suppressions, baseline, runner.

The port of the JAX package's ``analysis/core.py``: the same plumbing,
pointed at ``src/repro_torch/``.  The checker is a repo-specific
static-analysis pass over the Python AST for the invariants the
simulator relies on: RNG draw schedules that must not depend on call
batching, implicit device→host syncs in the event-loop hot path, side
effects inside functions a ``torch.func`` transform or an autograd
``Function`` runs, and the observability layer's read-only contract.
``repro_torch.analysis.rules`` encodes those contracts as rules; this
module is the plumbing:

* ``Finding``      — one diagnostic (code, file, line, col, message).
* suppressions     — ``# simlint: disable=SIM202 -- why`` on the finding
  line, ``# simlint: disable-next=...`` on the line above, or
  ``# simlint: disable-file=...`` anywhere for a whole module.
* ``Baseline``     — committed JSON of grandfathered findings (the port's
  own file, ``simlint-torch-baseline.json``); every
  entry carries a one-line justification and matches findings by
  (file, code, stripped source line), so entries survive pure line-number
  drift but die with the code they describe.
* ``run_paths``    — walk files, parse once, apply every registered rule,
  then classify each finding as active / suppressed / baselined.
"""
from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding", "ModuleInfo", "Baseline", "BaselineEntry", "LintReport",
    "lint_text", "run_paths", "find_repo_root", "DEFAULT_BASELINE_NAME",
]

DEFAULT_BASELINE_NAME = "simlint-torch-baseline.json"

_SUPPRESS_RE = re.compile(
    r"#\s*simlint:\s*(disable|disable-next|disable-file)"
    r"\s*=\s*([A-Za-z0-9_,\s]+?)\s*(?:--\s*(.*\S))?\s*$")


@dataclass(frozen=True)
class Finding:
    """One diagnostic, anchored to a repo-relative file and 1-based line."""
    code: str
    path: str                  # repo-relative posix path
    line: int
    col: int
    message: str
    status: str = "active"     # active | suppressed | baselined

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} " \
               f"{self.message}"

    def with_status(self, status: str) -> "Finding":
        return Finding(self.code, self.path, self.line, self.col,
                       self.message, status)


@dataclass
class ModuleInfo:
    """Parsed module handed to every rule: path + AST + source lines."""
    path: str                  # repo-relative posix path
    tree: ast.Module
    lines: List[str]           # raw source lines (1-based via line(n))

    def line(self, n: int) -> str:
        if 1 <= n <= len(self.lines):
            return self.lines[n - 1]
        return ""

    # --- path predicates rules share -----------------------------------
    def in_src_repro(self) -> bool:
        """Library code of the port (the reference's name kept)."""
        return self.path.startswith("src/repro_torch/")

    def in_obs(self) -> bool:
        return self.path.startswith("src/repro_torch/obs/")

    def is_testish(self) -> bool:
        """Test / example / script code — looser RNG-literal rules."""
        first = self.path.split("/", 1)[0]
        return (first in ("tests", "examples", "scripts", "benchmarks")
                or Path(self.path).name.startswith("test_"))


# Hot-path modules for the SIM2xx host-sync rules: the reference's list,
# mapped to the port (the event loop, the batched engine, the servers and
# the mobility models).
HOT_PATH_FILES = (
    "src/repro_torch/fl/driver.py",
    "src/repro_torch/fl/engine.py",
    "src/repro_torch/core/server.py",
    "src/repro_torch/core/hierarchy.py",
)
HOT_PATH_PREFIXES = ("src/repro_torch/mobility/",)


def in_hot_path(path: str) -> bool:
    return path in HOT_PATH_FILES or any(
        path.startswith(p) for p in HOT_PATH_PREFIXES)


# ----------------------------------------------------------------------
# suppressions
# ----------------------------------------------------------------------
class Suppressions:
    """Inline ``# simlint: disable`` pragmas parsed from one module."""

    def __init__(self, lines: Sequence[str]):
        self.at_line: Dict[int, set] = {}
        self.file_wide: set = set()
        for i, text in enumerate(lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            kind = m.group(1)
            codes = {c.strip().upper() for c in m.group(2).split(",")
                     if c.strip()}
            if kind == "disable-file":
                self.file_wide |= codes
            elif kind == "disable-next":
                self.at_line.setdefault(i + 1, set()).update(codes)
            else:
                self.at_line.setdefault(i, set()).update(codes)

    def covers(self, finding: Finding) -> bool:
        codes = self.at_line.get(finding.line, set()) | self.file_wide
        return finding.code in codes or "ALL" in codes


# ----------------------------------------------------------------------
# baseline
# ----------------------------------------------------------------------
@dataclass
class BaselineEntry:
    file: str
    code: str
    match: str                 # stripped source text of the finding line
    why: str                   # one-line justification (required)
    count: int = 1
    used: int = field(default=0, compare=False)

    def to_json(self) -> Dict:
        d = {"file": self.file, "code": self.code, "match": self.match,
             "why": self.why}
        if self.count != 1:
            d["count"] = self.count
        return d


class Baseline:
    """Committed grandfather list.  A finding is *baselined* when an entry
    with the same (file, code) whose ``match`` equals the stripped source
    line still has unused count.  Unmatched entries are *stale* — they
    describe code that no longer exists and should be pruned."""

    def __init__(self, entries: Iterable[BaselineEntry] = ()):
        self.entries = list(entries)

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        data = json.loads(path.read_text())
        entries = []
        for i, e in enumerate(data.get("entries", [])):
            why = str(e.get("why", "")).strip()
            if not why:
                raise ValueError(
                    f"{path}: baseline entry #{i} ({e.get('file')}, "
                    f"{e.get('code')}) has no 'why' justification")
            entries.append(BaselineEntry(
                file=e["file"], code=e["code"], match=e["match"],
                why=why, count=int(e.get("count", 1))))
        return cls(entries)

    def save(self, path: Path) -> None:
        payload = {
            "comment": "simlint grandfathered findings; every entry "
                       "needs a one-line 'why'. Regenerate with "
                       "--write-baseline, then fill in justifications.",
            "entries": [e.to_json() for e in self.entries],
        }
        path.write_text(json.dumps(payload, indent=2) + "\n")

    def covers(self, finding: Finding, source_line: str) -> bool:
        text = source_line.strip()
        for e in self.entries:
            if (e.file == finding.path and e.code == finding.code
                    and e.match == text and e.used < e.count):
                e.used += 1
                return True
        return False

    def stale(self) -> List[BaselineEntry]:
        return [e for e in self.entries if e.used < e.count]


# ----------------------------------------------------------------------
# runner
# ----------------------------------------------------------------------
@dataclass
class LintReport:
    findings: List[Finding]            # every finding, classified
    errors: List[str]                  # unparsable files etc.
    stale_baseline: List[BaselineEntry]

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if f.status == "active"]

    def to_json(self) -> Dict:
        return {
            "schema": "simlint-report-v1",
            "active": len(self.active),
            "findings": [
                {"code": f.code, "file": f.path, "line": f.line,
                 "col": f.col, "message": f.message, "status": f.status}
                for f in self.findings],
            "stale_baseline": [e.to_json() for e in self.stale_baseline],
            "errors": self.errors,
        }


def find_repo_root(start: Path) -> Path:
    """Nearest ancestor holding a repo marker (.git / ruff.toml)."""
    cur = start.resolve()
    if cur.is_file():
        cur = cur.parent
    for cand in (cur, *cur.parents):
        if (cand / ".git").exists() or (cand / "ruff.toml").exists():
            return cand
    return cur


def _rules():
    # local import: rules imports core for Finding/ModuleInfo
    from repro_torch.analysis import rules
    return rules.REGISTRY


def lint_text(text: str, path: str,
              select: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint one module given as source text under a virtual repo-relative
    ``path`` (rules scope themselves by path).  Inline suppressions apply;
    no baseline.  The primary entry point for rule fixtures/tests."""
    tree = ast.parse(text, filename=path)
    lines = text.splitlines()
    mod = ModuleInfo(path=path, tree=tree, lines=lines)
    sup = Suppressions(lines)
    found: List[Finding] = []
    for rule in _rules():
        if select and rule.code not in select:
            continue
        for f in rule.check(mod):
            found.append(f.with_status("suppressed") if sup.covers(f)
                         else f)
    found.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return found


def iter_py_files(paths: Sequence[Path]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    # dedupe, keep order
    seen = set()
    out = []
    for f in files:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            out.append(f)
    return out


def run_paths(paths: Sequence[Path], *, repo_root: Optional[Path] = None,
              baseline: Optional[Baseline] = None,
              select: Optional[Sequence[str]] = None) -> LintReport:
    """Lint every ``*.py`` under ``paths``; classify findings against the
    inline suppressions and the baseline."""
    root = repo_root or find_repo_root(paths[0] if paths else Path("."))
    findings: List[Finding] = []
    errors: List[str] = []
    for fpath in iter_py_files(paths):
        try:
            rel = fpath.resolve().relative_to(root).as_posix()
        except ValueError:
            rel = fpath.as_posix()
        try:
            text = fpath.read_text()
            per_file = lint_text(text, rel, select=select)
        except (SyntaxError, UnicodeDecodeError) as e:
            errors.append(f"{rel}: {e}")
            continue
        if baseline is not None:
            lines = text.splitlines()
            classified = []
            for f in per_file:
                if f.status == "active" and baseline.covers(
                        f, lines[f.line - 1] if f.line <= len(lines)
                        else ""):
                    f = f.with_status("baselined")
                classified.append(f)
            per_file = classified
        findings.extend(per_file)
    stale = baseline.stale() if baseline is not None else []
    return LintReport(findings=findings, errors=errors,
                      stale_baseline=stale)


def make_baseline(report: LintReport, lines_of: Dict[str, List[str]],
                  why: str = "TODO: justify") -> Baseline:
    """Grandfather every active finding of ``report`` (used by
    ``--write-baseline``); justifications start as TODOs the author must
    fill in — the loader rejects empty ones, and CI loads the baseline."""
    counts: Dict[Tuple[str, str, str], int] = {}
    for f in report.active:
        src = lines_of.get(f.path, [])
        text = src[f.line - 1].strip() if f.line <= len(src) else ""
        counts[(f.path, f.code, text)] = counts.get(
            (f.path, f.code, text), 0) + 1
    entries = [BaselineEntry(file=p, code=c, match=m, why=why, count=n)
               for (p, c, m), n in sorted(counts.items())]
    return Baseline(entries)
