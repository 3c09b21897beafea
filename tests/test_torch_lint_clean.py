"""The port is torchlint-clean: scripts/run_torch_lint.py over
lightgbm_tpu_torch/ exits 0 with the reviewed allowlist
(scripts/lint_torch_allowlist.txt), the four threadlint rules find
nothing with an empty allowlist, and every suppression carries its
reason; a deliberate host read on the per-tree path names the counter
that counts it (`last_host_syncs`).  A host read added to a learner's
loop, a float atomic accumulation, a collective under a rank branch or
a thread-safety hazard anywhere in the port fails here."""
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "run_torch_lint.py")
THREAD_RULES = ("unguarded-shared-state", "lock-order-cycle",
                "blocking-under-lock", "condition-misuse")


def _suppressions():
    """(path, line number, text) of every torchlint comment in the port
    (the linters' own docstrings, which show the grammar, left out)."""
    out = []
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT,
                                                      "lightgbm_tpu_torch")):
        for fn in sorted(files):
            if fn.endswith(".py") and not (
                    os.path.basename(dirpath) == "diagnostics"
                    and fn in ("lint.py", "threadlint.py")):
                path = os.path.join(dirpath, fn)
                with open(path) as fh:
                    out += [(path, i, line) for i, line in enumerate(fh, 1)
                            if re.search(r"#\s*torchlint:\s*allow", line)]
    return out


def test_port_is_lint_clean():
    r = subprocess.run([sys.executable, SCRIPT], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "torchlint OK" in r.stdout


def test_threadlint_rules_are_clean_with_an_empty_allowlist():
    r = subprocess.run([sys.executable, SCRIPT, "--json", "--no-allowlist",
                        "--rules", ",".join(THREAD_RULES)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    payload = json.loads(r.stdout)
    assert payload["ok"] is True and payload["findings"] == []


def test_every_suppression_carries_a_reason():
    bare = re.compile(r"torchlint:\s*allow\([a-z-]+(?:\s*,\s*[a-z-]+)*\)"
                      r"\s*(?:[-—–:]+\s*)?$")
    sup = _suppressions()
    assert sup
    offenders = [f"{p}:{i}" for p, i, line in sup if bare.search(line)]
    assert not offenders, offenders


def test_allowed_host_reads_name_their_counter():
    """The per-tree reads allowed inline: the rounds learner's round read,
    the tree fetch, the serial learner's split reads; each reason names
    last_host_syncs."""
    reads = [(p, i, line) for p, i, line in _suppressions()
             if "allow(host-sync)" in line]
    assert {os.path.basename(p) for p, _, _ in reads} == {
        "rounds.py", "fused.py", "serial.py"}
    for p, i, line in reads:
        assert "last_host_syncs" in line, f"{p}:{i}"
