"""torchlint rule fixtures (lightgbm_tpu_torch/diagnostics/lint.py): for
each rule a seeded hazard that it flags and a clean twin that it passes,
written as source under tmp_path (the linter is pure AST: nothing here
runs).  A fixture package mirrors the port's layout where a rule keys on
it: `learner/rounds.py` holds a per-tree root, `sharded/mesh.py` the
mesh layer and its AXES.  Also: the reasoned-suppression grammar, the
allowlist (a reason-less entry, a stale entry), and the JAX rules that
the module's docstring must name with the reason the port has nothing
for them."""
import os
import subprocess
import sys
import textwrap

import pytest

from lightgbm_tpu_torch.diagnostics import lint
from lightgbm_tpu_torch.diagnostics.lint import RULES, lint_paths, lint_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESH = """
    import torch
    import torch.distributed as dist

    AXES = ("data", "feature")

    class Mesh:
        def psum(self, t, axes=None):
            dist.all_reduce(t)
            return t

        def size(self, axis):
            return 1
"""


def write_pkg(tmp_path, files):
    """Write {relative path: source} under tmp_path/pkg; returns its
    directory."""
    pkg = tmp_path / "pkg"
    for rel, src in files.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        for d in [p.parent] + list(p.parent.parents):
            if d == tmp_path:
                break
            (d / "__init__.py").touch()
        p.write_text(textwrap.dedent(src))
    return str(pkg)


def run(tmp_path, files, allowlist=None):
    return lint_paths([write_pkg(tmp_path, files)], str(tmp_path),
                      allowlist or {})


def has(findings, rule, needle=""):
    return any(f.rule == rule and needle in f.message for f in findings)


def rounds(body):
    """A per-tree root (RoundsTreeLearner.train_device) calling a helper
    whose body is `body`."""
    head = textwrap.dedent("""
        import torch

        class RoundsTreeLearner:
            def train_device(self, grad, hess, bag):
                return _round(grad)

        def _round(grad):
        """)
    return {"learner/rounds.py": head + textwrap.indent(body, "    ")}


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hazard", [
    "n = torch.cat([grad, grad]).sum()\nreturn n.item()",
    "m = torch.max(grad)\nreturn m.tolist()",
    "return grad.cpu()",
    "return grad.numpy()",
    "m = torch.sum(grad) * 2\nreturn float(m)",
    "torch.cuda.synchronize()\nreturn grad",
    "m = torch.sum(grad) > 0\nif m:\n    return grad\nreturn grad",
    "m = torch.any(grad > 0)\nwhile m:\n    m = grad.sum() > 1\nreturn m",
    "s = torch.sum(grad)\nassert s > 0\nreturn grad",
], ids=["item", "tolist", "cpu", "numpy", "float", "synchronize",
        "if_tensor", "while_tensor", "assert_tensor"])
def test_host_sync_in_the_per_tree_loop_is_flagged(tmp_path, hazard):
    """Tensors by construction (torch.* results and what is derived from
    them) read in a function the root reaches."""
    assert has(run(tmp_path, rounds(hazard)), "host-sync")


@pytest.mark.parametrize("clean", [
    "n = grad.shape[0]\nif n:\n    return grad\nreturn grad",
    "if grad is None:\n    return grad\nreturn grad * 2",
    "if grad.numel():\n    return grad\nreturn grad",
    "import numpy as np\na = np.zeros(3)\nreturn a.tolist()",
    "host = [1, 2]\nreturn int(host[0])",
], ids=["shape", "is_none", "numel", "numpy_tolist", "host_int"])
def test_host_values_in_the_per_tree_loop_are_clean(tmp_path, clean):
    assert not has(run(tmp_path, rounds(clean)), "host-sync")


def test_a_read_outside_the_per_tree_region_is_clean(tmp_path):
    """The same .item() in a function no root reaches (set-up code)."""
    fs = run(tmp_path, {"learner/rounds.py": """
        import torch

        class RoundsTreeLearner:
            def train_device(self, grad, hess, bag):
                return grad

        def setup(x):
            return torch.zeros(3).sum().item()
        """})
    assert not has(fs, "host-sync")


def test_reachability_follows_calls_across_modules(tmp_path):
    """The root calls into another module of the package (a `from ..ops
    import` name): the read there is on the per-tree path."""
    fs = run(tmp_path, {
        "learner/rounds.py": """
            from ..ops.split import best

            class RoundsTreeLearner:
                def train_device(self, grad, hess, bag):
                    return best(grad)
            """,
        "ops/split.py": """
            import torch

            def best(h):
                return torch.argmax(h).item()
            """})
    assert has(fs, "host-sync", ".item()")


def test_reasoned_suppression_silences_and_bare_one_is_a_finding(tmp_path):
    ok = rounds("n = torch.sum(grad)\n"
                "# torchlint: allow(host-sync) — counted in last_host_syncs\n"
                "return n.item()")
    assert run(tmp_path, ok) == []
    bare = rounds("n = torch.sum(grad)\n"
                  "# torchlint: allow(host-sync)\n"
                  "return n.item()")
    fs = run(tmp_path, bare)
    assert has(fs, "suppression", "no reason")
    assert not has(fs, "host-sync")


# ---------------------------------------------------------------------------
# nondeterminism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,flagged", [
    ("def f(idx, v):\n"
     "    out = torch.zeros(8)\n"
     "    return out.index_add_(0, idx, v)\n", True),
    ("def f(idx, v):\n"
     "    out = torch.zeros(8, dtype=torch.int32)\n"
     "    return out.index_add_(0, idx, v)\n", False),
    ("def f(idx, v):\n"
     "    out = torch.zeros(8)\n"
     "    return out.scatter_add_(0, idx, v)\n", True),
    ("def f(out, idx, v):\n"
     "    return out.index_put_((idx,), v, accumulate=True)\n", True),
    ("def f(out, idx, v):\n"
     "    return out.index_put_((idx,), v, accumulate=False)\n", False),
    ("def f(n):\n"
     "    return torch.rand(n)\n", True),
    ("def f(n, g):\n"
     "    return torch.rand(n, generator=g)\n", False),
    ("def f(n):\n"
     "    return torch.randperm(n)\n", True),
    ("def f():\n"
     "    t0 = time.time()\n"
     "    return torch.tensor(t0)\n", True),
    ("def f():\n"
     "    t0 = time.time()\n"
     "    return torch.tensor(1.0), t0\n", False),
], ids=["float_index_add", "int_index_add", "scatter_add",
        "index_put_accumulate", "index_put_plain", "rand", "rand_generator",
        "randperm", "clock_to_tensor", "clock_beside"])
def test_nondeterminism(tmp_path, src, flagged):
    fs = run(tmp_path, {"ops/x.py": "import time\nimport torch\n\n\n" + src})
    assert has(fs, "nondeterminism") is flagged


# ---------------------------------------------------------------------------
# divergent-collective, collective-mismatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,flagged", [
    ("def f(t, rank):\n"
     "    if rank == 0:\n"
     "        dist.all_reduce(t)\n"
     "    return t\n", True),
    ("def f(t):\n"
     "    if dist.get_rank() == 0:\n"
     "        dist.barrier()\n"
     "    else:\n"
     "        pass\n"
     "    return t\n", True),
    ("def f(t, mesh):\n"
     "    if mesh.rank == 0:\n"
     "        t = mesh.psum(t, 'data')\n"
     "    return t\n", True),
    ("def f(t, mesh):\n"
     "    if mesh.rank == 0:\n"
     "        t = mesh.psum(t, 'data')\n"
     "    else:\n"
     "        t = mesh.psum(t * 2, 'data')\n"
     "    return t\n", False),
    ("def f(t, rank):\n"
     "    if rank == 0:\n"
     "        print(t)\n"
     "    return t\n", False),
    ("def f(t, n):\n"
     "    if n > 1:\n"
     "        dist.all_reduce(t)\n"
     "    return t\n", False),
], ids=["dist_under_rank", "get_rank_barrier", "mesh_method_under_rank",
        "both_branches", "no_collective", "not_a_rank_test"])
def test_divergent_collective(tmp_path, src, flagged):
    fs = run(tmp_path, {
        "sharded/mesh.py": MESH,
        "learner/x.py": "import torch.distributed as dist\n\n\n" + src})
    assert has(fs, "divergent-collective") is flagged


def test_collective_through_a_package_call_is_seen(tmp_path):
    """A branch that calls a package function that reaches a
    collective."""
    fs = run(tmp_path, {
        "sharded/mesh.py": MESH,
        "learner/x.py": """
            import torch.distributed as dist

            def sync(t):
                dist.all_reduce(t)
                return t

            def f(t, rank):
                if rank == 1:
                    t = sync(t)
                return t
            """})
    assert has(fs, "divergent-collective")


@pytest.mark.parametrize("axis,flagged", [("'rows'", True),
                                           ("'data'", False),
                                           ("('data', 'feature')", False)])
def test_collective_mismatch(tmp_path, axis, flagged):
    fs = run(tmp_path, {
        "sharded/mesh.py": MESH,
        "learner/x.py": f"def f(t, mesh):\n"
                        f"    return mesh.psum(t, {axis})\n"})
    assert has(fs, "collective-mismatch") is flagged


def test_collective_mismatch_stands_down_without_axes(tmp_path):
    fs = run(tmp_path, {"learner/x.py": "def f(t, mesh):\n"
                                        "    return mesh.psum(t, 'rows')\n"})
    assert not has(fs, "collective-mismatch")


# ---------------------------------------------------------------------------
# allowlist, registry, docstring
# ---------------------------------------------------------------------------


def test_allowlist_entry_silences_needs_a_reason_and_goes_stale(tmp_path):
    files = {"ops/x.py": "import torch\n\n\ndef f(n):\n"
                         "    return torch.rand(n)\n"}
    pkg = write_pkg(tmp_path, files)
    key = ("pkg/ops/x.py", "nondeterminism", "f")
    fs, stale = lint_run([pkg], str(tmp_path), {key: "a reviewed reason"})
    assert fs == [] and stale == []
    fs, _ = lint_run([pkg], str(tmp_path), {key: ""})
    assert has(fs, "suppression", "allowlist entry has no reason")
    gone = ("pkg/ops/x.py", "nondeterminism", "renamed_away")
    deleted = ("pkg/ops/gone.py", "host-sync", "f")
    fs, stale = lint_run([pkg], str(tmp_path),
                         {key: "a reason", gone: "stale", deleted: "gone"})
    assert len(stale) == 2
    assert any("renamed_away" in s for s in stale)
    assert any("gone.py" in s for s in stale)


def test_runner_fails_on_a_stale_allowlist_entry(tmp_path):
    """scripts/run_torch_lint.py over the port with the reviewed
    allowlist plus one entry that produces no finding: rc 1, the entry
    named; a rule-filtered run skips the audit."""
    allow = tmp_path / "allow.txt"
    with open(os.path.join(ROOT, "scripts", "lint_torch_allowlist.txt")) as f:
        allow.write_text(f.read() + "\nlightgbm_tpu_torch/engine.py::"
                         "host-sync::train — no such finding\n")
    script = os.path.join(ROOT, "scripts", "run_torch_lint.py")
    r = subprocess.run([sys.executable, script, "--allowlist", str(allow)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert "stale allowlist entry: lightgbm_tpu_torch/engine.py" in r.stdout
    r = subprocess.run([sys.executable, script, "--allowlist", str(allow),
                        "--rules", "host-sync"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout


def test_rules_registry_and_the_jax_rules_named():
    assert RULES == ("host-sync", "nondeterminism", "divergent-collective",
                     "collective-mismatch")
    doc = lint.__doc__
    for rule in ("retrace-hazard", "dtype-drift", "scatter-divisibility",
                 "replication-leak"):
        assert f"``{rule}``" in doc
    assert lint.HOT_ROOTS and all(len(r) == 2 for r in lint.HOT_ROOTS)


def test_the_hot_roots_name_the_learners():
    """Every root names a function that exists in the port."""
    pkg = lint.Package(ROOT)
    pkg.add_tree(os.path.join(ROOT, "lightgbm_tpu_torch"))
    for suffix, qual in lint.HOT_ROOTS:
        mods = [m for m in pkg.modules.values()
                if m.name.endswith("." + suffix)]
        assert len(mods) == 1 and qual in mods[0].funcs, (suffix, qual)
