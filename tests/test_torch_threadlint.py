"""threadlint rule-by-rule fixtures for the port's copy
(lightgbm_tpu_torch/diagnostics/threadlint.py, over the port's
diagnostics/lint.py): the JAX package's tests/test_threadlint.py cases,
one true positive AND one true negative per rule —
unguarded-shared-state, lock-order-cycle (incl. a CROSS-MODULE cycle
through the call graph), blocking-under-lock (incl. blocking hidden in
a class constructor), condition-misuse — plus the `# guarded by`
annotation convention, the reasoned-suppression grammar (``torchlint:
allow(...)``), the threadlint slice of the stale-allowlist audit, the
--rules CLI of scripts/run_torch_lint.py, and a torch synchronize()
under a lock.

These are SOURCE fixtures — the linter is pure AST, so nothing here is
executed (the fixture threads never start)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from lightgbm_tpu_torch.diagnostics.threadlint import (RULES, lint_paths,
                                                       lint_run)

pytestmark = pytest.mark.quick

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEADER = """
    import threading
    import time
"""


def run_lint(tmp_path, src, allowlist=None, name="fixture_mod.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(HEADER) + textwrap.dedent(src))
    return lint_paths([str(p)], str(tmp_path), allowlist or {})


def has(findings, rule, needle=""):
    return any(f.rule == rule and needle in f.message for f in findings)


# ---------------------------------------------------------------------------
# unguarded-shared-state
# ---------------------------------------------------------------------------


def test_unguarded_write_from_plural_thread_root(tmp_path):
    """A worker-pool entry point (threads built in a comprehension — a
    PLURAL root) writing an instance attr without the lock."""
    fs = run_lint(tmp_path, """
        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self.done = 0
                self._threads = [
                    threading.Thread(target=self._work)
                    for _ in range(4)]

            def _work(self):
                self.done += 1
        """)
    assert has(fs, "unguarded-shared-state", "'self.done'")


def test_guarded_write_is_clean(tmp_path):
    fs = run_lint(tmp_path, """
        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self.done = 0
                self._threads = [
                    threading.Thread(target=self._work)
                    for _ in range(4)]

            def _work(self):
                with self._lock:
                    self.done += 1
        """)
    assert not has(fs, "unguarded-shared-state")


def test_guarded_by_annotation_convention(tmp_path):
    """`# guarded by <lock>` names a guard the lexical scan cannot see
    (a caller-held lock) — documented convention, no finding."""
    fs = run_lint(tmp_path, """
        class Worker:
            def __init__(self):
                self.done = 0
                self._threads = [
                    threading.Thread(target=self._work)
                    for _ in range(4)]

            def _work(self):
                # guarded by the registry writer lock (callers hold it)
                self.done += 1
        """)
    assert not has(fs, "unguarded-shared-state")


def test_init_writes_are_not_shared_state(tmp_path):
    """__init__ runs before the threads exist — its writes never count."""
    fs = run_lint(tmp_path, """
        class Worker:
            def __init__(self):
                self.done = 0
                self._threads = [
                    threading.Thread(target=self._idle)
                    for _ in range(4)]

            def _idle(self):
                pass
        """)
    assert not has(fs, "unguarded-shared-state")


def test_single_root_write_is_not_shared(tmp_path):
    """One NON-plural thread root writing an attr: no concurrent writer
    exists, so no finding."""
    fs = run_lint(tmp_path, """
        class Poller:
            def __init__(self):
                self.polls = 0
                self._thread = threading.Thread(target=self._loop)

            def _loop(self):
                self.polls += 1
        """)
    assert not has(fs, "unguarded-shared-state")


def test_suppression_applies_to_threadlint_rules(tmp_path):
    fs = run_lint(tmp_path, """
        class Worker:
            def __init__(self):
                self.done = 0
                self._threads = [
                    threading.Thread(target=self._work)
                    for _ in range(4)]

            def _work(self):
                # torchlint: allow(unguarded-shared-state) — monotonic \
gauge, torn reads acceptable in /stats
                self.done += 1
        """)
    assert not has(fs, "unguarded-shared-state")
    assert not has(fs, "suppression")


def test_bare_suppression_surfaces_as_finding(tmp_path):
    fs = run_lint(tmp_path, """
        class Worker:
            def __init__(self):
                self.done = 0
                self._threads = [
                    threading.Thread(target=self._work)
                    for _ in range(4)]

            def _work(self):
                # torchlint: allow(unguarded-shared-state)
                self.done += 1
        """)
    assert has(fs, "suppression", "no reason")


# ---------------------------------------------------------------------------
# lock-order-cycle
# ---------------------------------------------------------------------------


def test_abba_cycle_in_one_class(tmp_path):
    fs = run_lint(tmp_path, """
        class S:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._b:
                    with self._a:
                        pass
        """)
    assert has(fs, "lock-order-cycle", "deadlock")


def test_consistent_order_is_clean(tmp_path):
    fs = run_lint(tmp_path, """
        class S:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._a:
                    with self._b:
                        pass
        """)
    assert not has(fs, "lock-order-cycle")


def test_try_lock_inserts_no_edge(tmp_path):
    """acquire(blocking=False) cannot deadlock — no reverse edge, no
    cycle (the registry's shadow-verdict pattern)."""
    fs = run_lint(tmp_path, """
        class S:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a:
                    got = self._b.acquire(blocking=False)

            def two(self):
                with self._b:
                    with self._a:
                        pass
        """)
    assert not has(fs, "lock-order-cycle")


def test_cross_module_cycle_through_calls(tmp_path):
    """Module A takes LOCK_A then calls into module B (which takes
    LOCK_B); module B takes LOCK_B then calls back into A (which takes
    LOCK_A).  Neither file alone has a cycle — the call graph does."""
    (tmp_path / "a_mod.py").write_text(textwrap.dedent("""
        import threading
        from b_mod import take_b

        LOCK_A = threading.Lock()

        def with_a_then_b():
            with LOCK_A:
                take_b()

        def grab_a():
            with LOCK_A:
                pass
        """))
    (tmp_path / "b_mod.py").write_text(textwrap.dedent("""
        import threading
        from a_mod import grab_a

        LOCK_B = threading.Lock()

        def take_b():
            with LOCK_B:
                pass

        def with_b_then_a():
            with LOCK_B:
                grab_a()
        """))
    fs = lint_paths([str(tmp_path / "a_mod.py"),
                     str(tmp_path / "b_mod.py")], str(tmp_path), {})
    assert has(fs, "lock-order-cycle", "LOCK_A")
    assert has(fs, "lock-order-cycle", "LOCK_B")


# ---------------------------------------------------------------------------
# blocking-under-lock
# ---------------------------------------------------------------------------


def test_sleep_under_lock(tmp_path):
    fs = run_lint(tmp_path, """
        class Poller:
            def __init__(self):
                self._lock = threading.Lock()
                self._thread = threading.Thread(target=self._loop)

            def _loop(self):
                with self._lock:
                    time.sleep(0.5)
        """)
    assert has(fs, "blocking-under-lock", "time.sleep")


def test_sleep_outside_lock_is_clean(tmp_path):
    fs = run_lint(tmp_path, """
        class Poller:
            def __init__(self):
                self._lock = threading.Lock()
                self._thread = threading.Thread(target=self._loop)

            def _loop(self):
                with self._lock:
                    pass
                time.sleep(0.5)
        """)
    assert not has(fs, "blocking-under-lock")


def test_blocking_hidden_in_constructor(tmp_path):
    """A class instantiation under a lock resolves to __init__, whose
    file I/O propagates — the registry's Booster(model_file=...) shape."""
    fs = run_lint(tmp_path, """
        class Loader:
            def __init__(self, path):
                with open(path) as fh:
                    self.text = fh.read()

        class Reloader:
            def __init__(self):
                self._lock = threading.Lock()
                self._thread = threading.Thread(target=self._reload)

            def _reload(self):
                with self._lock:
                    self.model = Loader("model.txt")
        """)
    assert has(fs, "blocking-under-lock", "Loader.__init__")


def test_timeout_less_wait_with_other_lock_held(tmp_path):
    """Condition.wait with NO timeout while holding a DIFFERENT lock:
    the waiter parks with that lock held — swap starvation."""
    fs = run_lint(tmp_path, """
        class Gate:
            def __init__(self):
                self._lock = threading.Lock()
                self._cond = threading.Condition()
                self.ready = False
                self._thread = threading.Thread(target=self._run)

            def _run(self):
                with self._lock:
                    with self._cond:
                        while not self.ready:
                            self._cond.wait()
        """)
    assert has(fs, "blocking-under-lock", "Condition.wait")


def test_bounded_wait_without_other_locks_is_clean(tmp_path):
    fs = run_lint(tmp_path, """
        class Gate:
            def __init__(self):
                self._cond = threading.Condition()
                self.ready = False
                self._thread = threading.Thread(target=self._run)

            def _run(self):
                with self._cond:
                    while not self.ready:
                        self._cond.wait(0.1)
        """)
    assert not has(fs, "blocking-under-lock")


def test_unreached_code_is_outside_the_concurrent_region(tmp_path):
    """The same blocking-under-lock shape with NO thread root anywhere:
    single-threaded code may hold a lock across I/O freely."""
    fs = run_lint(tmp_path, """
        class Loader:
            def __init__(self):
                self._lock = threading.Lock()

            def load(self):
                with self._lock:
                    time.sleep(0.5)
        """)
    assert not has(fs, "blocking-under-lock")


# ---------------------------------------------------------------------------
# condition-misuse
# ---------------------------------------------------------------------------


def test_wait_not_in_while_loop(tmp_path):
    fs = run_lint(tmp_path, """
        class Gate:
            def __init__(self):
                self._cond = threading.Condition()
                self.ready = False
                self._thread = threading.Thread(target=self._run)

            def _run(self):
                with self._cond:
                    if not self.ready:
                        self._cond.wait(0.1)
        """)
    assert has(fs, "condition-misuse", "while")


def test_notify_without_condition_held(tmp_path):
    fs = run_lint(tmp_path, """
        class Gate:
            def __init__(self):
                self._cond = threading.Condition()
                self.ready = False
                self._thread = threading.Thread(target=self._kick)

            def _kick(self):
                self._cond.notify_all()
        """)
    assert has(fs, "condition-misuse", "notify")


def test_canonical_waiter_is_clean(tmp_path):
    fs = run_lint(tmp_path, """
        class Gate:
            def __init__(self):
                self._cond = threading.Condition()
                self.ready = False
                self._t1 = threading.Thread(target=self._run)
                self._t2 = threading.Thread(target=self._kick)

            def _run(self):
                with self._cond:
                    while not self.ready:
                        self._cond.wait(0.1)

            def _kick(self):
                with self._cond:
                    self.ready = True
                    self._cond.notify_all()
        """)
    assert not has(fs, "condition-misuse")
    assert not has(fs, "unguarded-shared-state")


# ---------------------------------------------------------------------------
# allowlist + CLI
# ---------------------------------------------------------------------------


def test_threadlint_stale_allowlist_slice(tmp_path):
    """threadlint audits exactly ITS rules' entries: a used entry
    passes, an unused one and a deleted-file one go stale, and a
    torchlint-rule entry is not threadlint's to judge."""
    src = """
        class Worker:
            def __init__(self):
                self.done = 0
                self._threads = [
                    threading.Thread(target=self._work)
                    for _ in range(4)]

            def _work(self):
                self.done += 1
        """
    p = tmp_path / "fixture_mod.py"
    p.write_text(textwrap.dedent(HEADER) + textwrap.dedent(src))
    allow = {
        ("fixture_mod.py", "unguarded-shared-state", "Worker._work"):
            "reviewed reason",
        ("fixture_mod.py", "unguarded-shared-state", "renamed_away"):
            "stale entry",
        ("gone_mod.py", "lock-order-cycle", "f"): "file deleted",
        ("fixture_mod.py", "host-sync", "Worker._work"):
            "torchlint's business, not threadlint's",
    }
    findings, stale = lint_run([str(p)], str(tmp_path), allow)
    assert not any(f.rule == "unguarded-shared-state" for f in findings)
    assert len(stale) == 2
    assert any("renamed_away" in s for s in stale)
    assert any("gone_mod.py" in s for s in stale)


def test_run_lint_rules_flag_selects_threadlint(tmp_path):
    p = tmp_path / "fixture_mod.py"
    p.write_text(textwrap.dedent(HEADER) + textwrap.dedent("""
        class Worker:
            def __init__(self):
                self.done = 0
                self._threads = [
                    threading.Thread(target=self._work)
                    for _ in range(4)]

            def _work(self):
                self.done += 1
        """))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "run_torch_lint.py"),
         "--json", "--rules", "unguarded-shared-state", str(p)],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    out = json.loads(r.stdout)
    assert out["ok"] is False
    f = next(f for f in out["findings"]
             if f["rule"] == "unguarded-shared-state")
    assert set(f) == {"file", "line", "rule", "qualname", "message"}
    assert f["qualname"] == "Worker._work"
    # rule selection filters the OTHER families out
    assert all(fd["rule"] in ("unguarded-shared-state", "suppression")
               for fd in out["findings"])


def test_rules_registry_is_the_documented_four():
    assert RULES == ("unguarded-shared-state", "lock-order-cycle",
                     "blocking-under-lock", "condition-misuse")


def test_device_synchronize_under_lock(tmp_path):
    """torch.cuda.synchronize() (or a stream's synchronize()) under a
    lock on a thread root stalls every waiter on the device queue; the
    same call outside the lock is clean."""
    fs = run_lint(tmp_path, """
        import torch

        class Dispatch:
            def __init__(self):
                self._lock = threading.Lock()
                self._t = threading.Thread(target=self._run)

            def _run(self):
                with self._lock:
                    torch.cuda.synchronize()
        """)
    assert has(fs, "blocking-under-lock", "synchronize")
    fs = run_lint(tmp_path, """
        import torch

        class Dispatch:
            def __init__(self):
                self._lock = threading.Lock()
                self._t = threading.Thread(target=self._run)

            def _run(self):
                with self._lock:
                    pass
                torch.cuda.synchronize()
        """)
    assert not has(fs, "blocking-under-lock")
