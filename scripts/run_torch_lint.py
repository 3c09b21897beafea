"""torchlint CLI: the port's static checks over lightgbm_tpu_torch/.

Two rule families run in one invocation:

- torchlint (lightgbm_tpu_torch/diagnostics/lint.py): host syncs in the
  learners' per-tree loops, nondeterministic float accumulation and
  unseeded draws, collectives under a rank-dependent branch, mesh axis
  names;
- threadlint (lightgbm_tpu_torch/diagnostics/threadlint.py):
  concurrency in the threaded serving, router and online plane —
  unguarded shared state, lock-order cycles, blocking under a lock,
  Condition misuse.

Prints `path:line: rule: message [in qualname]` findings and exits
nonzero when any survive the reasoned inline suppressions and the
reviewed allowlist (scripts/lint_torch_allowlist.txt), or when an
allowlist entry is stale (its path::rule::qualname no longer exists or
no longer produces a finding).  Each linter audits its own rules'
entries.

`--json` prints the findings and stale entries as one JSON object on
stdout and the summary on stderr.  `--rules a,b,...` runs only the named
rules (and skips the stale audit: with rules left out, a missing finding
proves nothing).  The same arguments as scripts/run_lint.py:

    python scripts/run_torch_lint.py [--json] [--rules r1,r2]
        [--allowlist FILE | --no-allowlist] [paths...]

Standard library only: the linters are loaded by path, without importing
the package (and torch).
"""
import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(ROOT, "lightgbm_tpu_torch")


def _load(name: str, filename: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(PKG_DIR, "diagnostics", filename))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod       # dataclasses resolves annotations here
    spec.loader.exec_module(mod)
    return mod


# lint.py first: threadlint rides its Package machinery
_lint = _load("torchlint", "lint.py")
_threadlint = _load("torchlint_threads", "threadlint.py")

ALLOWLIST_FILE = os.path.join(ROOT, "scripts", "lint_torch_allowlist.txt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="*", default=[PKG_DIR],
                    help="files or directories (default: the port)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout; the "
                         "summary goes to stderr")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule names to run (default: "
                         "every torchlint and threadlint rule); skips "
                         "the stale-allowlist audit")
    ap.add_argument("--allowlist", default=ALLOWLIST_FILE,
                    help="reviewed allowlist file (default: "
                         "scripts/lint_torch_allowlist.txt)")
    ap.add_argument("--no-allowlist", action="store_true",
                    help="ignore the allowlist (show every finding; no "
                         "stale-entry check)")
    args = ap.parse_args(argv)

    allow = {} if args.no_allowlist else _lint.load_allowlist(args.allowlist)
    thread_rules = set(_threadlint.RULES)
    thread_allow = {k: v for k, v in allow.items() if k[1] in thread_rules}
    torch_allow = {k: v for k, v in allow.items()
                   if k[1] not in thread_rules}
    rules = (None if args.rules is None
             else {r.strip() for r in args.rules.split(",") if r.strip()})

    paths = [os.path.abspath(p) for p in args.paths]
    # the stale audit needs the whole package: whether an entry still
    # produces its finding can depend on other files (reachability)
    full_scope = (any(p == PKG_DIR for p in paths) and rules is None
                  and not args.no_allowlist)

    findings, stale = [], []
    if rules is None or rules - thread_rules:
        f, s = _lint.lint_run(paths, ROOT, torch_allow,
                              check_stale=full_scope)
        findings += f
        stale += s
    if rules is None or rules & thread_rules:
        f, s = _threadlint.lint_run(paths, ROOT, thread_allow,
                                    check_stale=full_scope)
        findings += f
        stale += s
    if rules is not None:
        # a reason-less suppression always surfaces
        findings = [f for f in findings
                    if f.rule in rules or f.rule == "suppression"]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    rc = 1 if (findings or stale) else 0

    by_rule = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    if rc:
        parts = [f"{r}: {n}" for r, n in sorted(by_rule.items())]
        if stale:
            parts.append(f"stale-allowlist: {len(stale)}")
        summary = (f"torchlint: {len(findings)} finding(s), {len(stale)} "
                   f"stale allowlist entr"
                   f"{'y' if len(stale) == 1 else 'ies'} "
                   f"({', '.join(parts)})")
    else:
        summary = ("torchlint OK: no host-sync, nondeterminism, "
                   "collective or thread-safety findings")

    if args.as_json:
        print(json.dumps({
            "ok": rc == 0,
            "findings": [{"file": f.path, "line": f.line, "rule": f.rule,
                          "qualname": f.qualname, "message": f.message}
                         for f in findings],
            "stale_allowlist": stale,
        }))
        print(summary, file=sys.stderr)
        return rc
    for f in findings:
        print(f.render())
    for s in stale:
        print(f"stale allowlist entry: {s}")
    print(summary)
    return rc


if __name__ == "__main__":
    sys.exit(main())
