"""Counter names of the port (scripts/check_torch_counter_names.py): a
registry call site in lightgbm_tpu_torch/, chip_smoke.py or the port's
scripts uses the canonical constant where one exists, and no two names
differ only by separator style.  The JAX package's
tests/test_counter_lint.py cases over the port's script, plus its
allowlist: an entry silences its site, and a stale entry fails."""
import importlib.util
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "check_torch_counter_names.py")


def _load():
    spec = importlib.util.spec_from_file_location("tccn", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_counter_names_are_clean():
    r = subprocess.run([sys.executable, SCRIPT], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "counter names OK" in r.stdout


def test_literal_retyping_a_constant_is_flagged():
    mod = _load()
    consts = {"serve.chunk_retries": ("lightgbm_tpu_torch/profiling.py",
                                      "SERVE_CHUNK_RETRIES")}
    sites = mod.scan_source('profiling.count("serve.chunk_retries")\n',
                            "x.py")
    assert sites == [("x.py", 1, "serve.chunk_retries")]
    findings = mod.lint(sites, consts)
    assert len(findings) == 1 and "SERVE_CHUNK_RETRIES" in findings[0]


def test_constant_usage_is_not_flagged():
    mod = _load()
    sites = mod.scan_source(
        "profiling.count(profiling.SERVE_CHUNK_RETRIES)\n"
        "count(SERVE_CHUNK_RETRIES, 2)\n", "x.py")
    assert sites == []


def test_prefix_style_twins_are_flagged():
    mod = _load()
    sites = (mod.scan_source('profiling.count("serve.swap")\n', "a.py")
             + mod.scan_source('profiling.count("serve/swap")\n', "b.py"))
    findings = mod.lint(sites, {})
    assert len(findings) == 1
    assert "a.py:1" in findings[0] and "b.py:1" in findings[0]


def test_allowlist_silences_a_site_and_a_stale_entry_fails(capsys):
    mod = _load()
    consts = {"serve.chunk_retries": ("lightgbm_tpu_torch/profiling.py",
                                      "SERVE_CHUNK_RETRIES")}
    sites = mod.scan_source('profiling.count("serve.chunk_retries")\n',
                            "x.py")
    used = set()
    allow = {("x.py", "serve.chunk_retries"): "a reviewed reason"}
    assert mod.lint(sites, consts, allow, used) == []
    assert used == {("x.py", "serve.chunk_retries")}
    assert mod.stale_entries(allow, used) == []
    mod.ALLOWLIST[("lightgbm_tpu_torch/engine.py", "no.such")] = "stale"
    assert mod.main() == 1
    assert "stale allowlist entry" in capsys.readouterr().out


def test_canonical_constants_are_the_ports():
    mod = _load()
    consts = mod.canonical_constants()
    assert all(rel.startswith("lightgbm_tpu_torch")
               for rel, _ in consts.values())
    assert consts["serve.chunk_retries"][1] == "SERVE_CHUNK_RETRIES"
    assert consts["tree/hist_rows_touched"][1] == "HIST_ROWS_TOUCHED"
