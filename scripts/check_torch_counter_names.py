"""Counter-name lint of the port: keep the profiling registry's names
mechanical.  The port's version of scripts/check_counter_names.py.

Two rules over every ``profiling.count`` / ``count_deferred`` /
``observe`` / ``labeled`` call site in lightgbm_tpu_torch/ (plus
chip_smoke.py and the port's scripts, scripts/*torch*.py) — ``labeled``
builds the per-model series keys
(``lgbt_..._total{model="..."}``), whose base names are ordinary
registry names:

1. **use-the-constant** — a call site whose first argument is a string
   LITERAL equal to the value of a module-level canonical constant
   (``UPPER_CASE = "..."`` in the port's profiling.py /
   diagnostics/sanitize.py / diagnostics/locksan.py) must use the
   constant instead: a re-typed string decouples the writer from the
   reader that uses the constant.
2. **one-prefix-style** — no two counter names in play (literals at
   call sites + canonical constant values) may differ only by separator
   style (``serve.chunk_retries`` vs ``serve/chunk_retries``): both
   sanitize to the SAME Prometheus metric name, so the /metrics surface
   would silently merge or shadow them.

A site that must keep its literal goes on ALLOWLIST below, keyed by
(path, literal), with its reason; an entry that matches no finding is
stale and fails the run.  Run standalone (exits nonzero on findings) and
from tests/test_torch_counter_lint.py:

    python scripts/check_torch_counter_names.py
"""
import ast
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the profiling-registry entry points whose first argument is a counter
# or reservoir name.  `labeled` is the per-model series constructor
# (profiling.labeled("serve.requests", model=...) → the registry key
# rendered as lgbt_serve_requests_total{model="..."}): its BASE name
# follows the same rules as any other registry name — canonical
# constants must be used, and a base that differs from another name
# only by separator style would merge with it at /metrics.
CALLS = ("count", "count_deferred", "observe", "labeled")

# where canonical constants live (module-level UPPER_CASE = "string")
CONSTANT_MODULES = (
    os.path.join("lightgbm_tpu_torch", "profiling.py"),
    os.path.join("lightgbm_tpu_torch", "diagnostics", "sanitize.py"),
    os.path.join("lightgbm_tpu_torch", "diagnostics", "locksan.py"),
)

# (repo-relative path, literal) -> reason: reviewed literal sites
ALLOWLIST = {}


def canonical_constants() -> Dict[str, Tuple[str, str]]:
    """{counter-name value: (module-relpath, CONSTANT_NAME)}."""
    out: Dict[str, Tuple[str, str]] = {}
    for rel in CONSTANT_MODULES:
        with open(os.path.join(ROOT, rel)) as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id.isupper()
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                out[node.value.value] = (rel, node.targets[0].id)
    return out


def scan_source(src: str, path: str) -> List[Tuple[str, int, str]]:
    """(path, lineno, literal) for every registry call whose first
    argument is a string literal — ``profiling.count("x")`` and bare
    ``count("x")`` both match."""
    sites: List[Tuple[str, int, str]] = []
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return sites
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = (fn.attr if isinstance(fn, ast.Attribute)
                else fn.id if isinstance(fn, ast.Name) else None)
        if name not in CALLS or not node.args:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            sites.append((path, node.lineno, arg.value))
    return sites


def scan_tree() -> List[Tuple[str, int, str]]:
    sites: List[Tuple[str, int, str]] = []
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(os.path.join(ROOT,
                                                      "lightgbm_tpu_torch")):
        files.extend(os.path.join(dirpath, n)
                     for n in sorted(names) if n.endswith(".py"))
    scripts = os.path.join(ROOT, "scripts")
    files.extend(os.path.join(scripts, n) for n in sorted(os.listdir(scripts))
                 if n.endswith(".py") and "torch" in n)
    for path in files:
        rel = os.path.relpath(path, ROOT)
        if rel.replace(os.sep, "/") == "scripts/check_torch_counter_names.py":
            continue                   # this linter's own examples
        with open(path) as f:
            sites.extend(scan_source(f.read(), rel))
    return sites


def normalize(name: str) -> str:
    """Collapse the two separator spellings (and anything else the
    Prometheus name sanitizer folds) so style-twins collide."""
    return re.sub(r"[^a-zA-Z0-9]+", "_", name).strip("_").lower()


def lint(sites: List[Tuple[str, int, str]],
         consts: Dict[str, Tuple[str, str]],
         allowlist: Optional[Dict[Tuple[str, str], str]] = None,
         used: Optional[set] = None) -> List[str]:
    """Findings of both rules; a use-the-constant site on `allowlist`
    (with a reason) is left out and recorded in `used`."""
    allowlist = allowlist or {}
    findings: List[str] = []
    for path, lineno, literal in sites:
        hit = consts.get(literal)
        key = (path.replace(os.sep, "/"), literal)
        if hit is not None and allowlist.get(key):
            if used is not None:
                used.add(key)
            continue
        # the defining module may restate its own constant's value (the
        # assignment itself is not a call site; anything else there is)
        if hit is not None:
            findings.append(
                f"{path}:{lineno}: literal {literal!r} re-types the "
                f"canonical constant {hit[1]} ({hit[0]}); use "
                f"profiling.{hit[1]}" if "profiling" in hit[0]
                else f"{path}:{lineno}: literal {literal!r} re-types the "
                     f"canonical constant {hit[1]} ({hit[0]}); use the "
                     "constant")
    by_norm: Dict[str, Dict[str, List[str]]] = {}
    for path, lineno, literal in sites:
        by_norm.setdefault(normalize(literal), {}).setdefault(
            literal, []).append(f"{path}:{lineno}")
    for value, (rel, cname) in consts.items():
        by_norm.setdefault(normalize(value), {}).setdefault(
            value, []).append(f"{rel}::{cname}")
    for norm, spellings in sorted(by_norm.items()):
        if len(spellings) > 1:
            detail = "; ".join(
                f"{s!r} at {', '.join(sorted(set(locs)))}"
                for s, locs in sorted(spellings.items()))
            findings.append(
                f"counter names differ only by prefix/separator style "
                f"(both sanitize to the same /metrics name "
                f"'lgbt_{norm}'): {detail}")
    return findings


def stale_entries(allowlist: Dict[Tuple[str, str], str],
                  used: set) -> List[str]:
    return [f"{path}::{literal} — matches no finding; remove the entry"
            for path, literal in sorted(allowlist) if (path, literal)
            not in used]


def main() -> int:
    consts = canonical_constants()
    sites = scan_tree()
    used: set = set()
    findings = lint(sites, consts, ALLOWLIST, used)
    stale = stale_entries(ALLOWLIST, used)
    if findings or stale:
        print("COUNTER-NAME LINT FINDINGS:")
        for f in findings:
            print(f"  - {f}")
        for s in stale:
            print(f"  - stale allowlist entry: {s}")
        return 1
    print(f"counter names OK: {len(sites)} literal call sites, "
          f"{len(consts)} canonical constants, no style twins")
    return 0


if __name__ == "__main__":
    sys.exit(main())
