"""Fail when a port `Config` field is dead: accepted but consumed nowhere
in lightgbm_tpu_torch/ and not on the allowlist below with a reason, and
fail when an allowlist entry is stale (the field is consumed now), so the
list only shrinks on purpose.  The port's version of
scripts/check_config_coverage.py.

Consumption is a word match over CODE ONLY: comments and docstrings are
stripped first, and so are the names inside the checkpoint fingerprint's
exclusion set (`_FINGERPRINT_EXCLUDE`, boosting/gbdt.py): naming a field
there says a resume may change it, not that anything reads it.  Counting
that set as use is how `telemetry_path` went dead unnoticed
(ROADMAP.md §C fault 11).  In config.py itself only the reads of
`config_from_params` count (it acts on a parsed config: the telemetry
sink).  The Config fields come from the dataclass's
AST in lightgbm_tpu_torch/config.py, so the check imports nothing:

    python scripts/check_torch_config_coverage.py
"""
import ast
import io
import os
import re
import sys
import tokenize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lightgbm_tpu_torch")

# Fields deliberately accepted and inert, each with its reason.  A new
# entry is a review decision; a new field is otherwise consumed.
ALLOWLIST = {
    "gpu_platform_id": "OpenCL selector kept for config compatibility",
    "gpu_device_id": "OpenCL selector kept for config compatibility",
    "gpu_use_dp": "OpenCL precision dial; histogram_dtype is the analog",
    "time_out": "socket-network timeout; torch.distributed has its own",
    "hist_dtype": "accumulation dtype override not implemented",
    "hist_input_dtype": "superseded by histogram_dtype; kept for compat",
    "fused_tree": "forced fused-learner selection not implemented",
    # found by this check (the fingerprint exclusion hid both, in the
    # JAX package too): accepted for config compatibility, read nowhere
    "num_threads": "the reference's OpenMP thread count; nothing sets "
                   "torch's threads from it",
    "output_freq": "the reference's metric-output period; the CLI prints "
                   "every iteration's metrics",
}

# assignments whose string literals name fields without consuming them
EXCLUDED_ASSIGNMENTS = ("_FINGERPRINT_EXCLUDE",)
# the one function of config.py whose reads of a Config are use (it acts
# on a parsed config, as telemetry_path's sink); the rest of config.py
# defines, aliases and validates the fields
CONFIG_CONSUMERS = ("config_from_params",)


def config_fields(path: str = os.path.join(PKG, "config.py")) -> list:
    """The annotated fields of `class Config`, in order."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "Config":
            return [st.target.id for st in node.body
                    if isinstance(st, ast.AnnAssign)
                    and isinstance(st.target, ast.Name)]
    raise RuntimeError(f"no class Config in {path}")


def _skipped_spans(src: str) -> list:
    """(first, last) lines of every docstring literal and of every
    assignment to a name in EXCLUDED_ASSIGNMENTS."""
    spans = []
    try:
        tree = ast.parse(src)
    except SyntaxError:              # pragma: no cover
        return spans
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = getattr(node, "body", [])
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                c = body[0].value
                spans.append((c.lineno, c.end_lineno))
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id in EXCLUDED_ASSIGNMENTS
                for t in node.targets):
            spans.append((node.value.lineno, node.value.end_lineno))
    return spans


def _code_only(src: str) -> str:
    """Source without comment tokens, and without the string tokens of
    docstrings and of the excluded assignments (matched by position, so
    escape sequences cannot defeat it).  Other strings stay:
    getattr(cfg, "hist_rows") is use."""
    spans = _skipped_spans(src)
    out = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                continue
            if tok.type == tokenize.STRING and any(
                    s <= tok.start[0] <= e for s, e in spans):
                continue
            out.append(tok.string if tok.type not in
                       (tokenize.NEWLINE, tokenize.NL) else "\n")
            out.append(" ")
    except tokenize.TokenError:      # pragma: no cover
        return src
    return "".join(out)


def _config_consumer_reads(path: str) -> str:
    """The attribute names that CONFIG_CONSUMERS read, one a line."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) \
                and node.name in CONFIG_CONSUMERS:
            names += [n.attr for n in ast.walk(node)
                      if isinstance(n, ast.Attribute)
                      and isinstance(n.ctx, ast.Load)]
    return "\n".join(names)


def consumed_blob(pkg: str = PKG) -> str:
    """The code of every module of the port but config.py, and the
    Config attributes that config.py's CONFIG_CONSUMERS read."""
    blob = [_config_consumer_reads(os.path.join(pkg, "config.py"))]
    for root, _dirs, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py") and not (root == pkg and f == "config.py"):
                with open(os.path.join(root, f)) as fh:
                    blob.append(_code_only(fh.read()))
    return "\n".join(blob)


def check(fields, blob, allowlist):
    """(dead fields, stale allowlist entries)."""
    dead, stale = [], []
    for name in fields:
        used = re.search(rf"\b{re.escape(name)}\b", blob) is not None
        if not used and name not in allowlist:
            dead.append(name)
        if used and name in allowlist:
            stale.append(name)
    return dead, stale


def main() -> int:
    fields = config_fields()
    dead, stale = check(fields, consumed_blob(), ALLOWLIST)
    rc = 0
    if dead:
        rc = 1
        print("DEAD CONFIG FIELDS (accepted but consumed nowhere in "
              "lightgbm_tpu_torch/; wire them up or allowlist them with a "
              "reason):")
        for name in dead:
            print(f"  - {name}")
    if stale:
        rc = 1
        print("STALE ALLOWLIST ENTRIES (now consumed; remove them from "
              "scripts/check_torch_config_coverage.py ALLOWLIST):")
        for name in stale:
            print(f"  - {name}")
    if rc == 0:
        print(f"config coverage OK: {len(fields)} fields, "
              f"{len(ALLOWLIST)} allowlisted as intentionally inert")
    return rc


if __name__ == "__main__":
    sys.exit(main())
