"""Dead Config fields in the port (scripts/check_torch_config_coverage.py):
every field of lightgbm_tpu_torch's Config is consumed in the port's code
or allowlisted with a reason; a stale entry fails; a field named only in
the checkpoint fingerprint's exclusion set is dead (how `telemetry_path`
hid: ROADMAP.md §C fault 11)."""
import importlib.util
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "check_torch_config_coverage.py")


def _load():
    spec = importlib.util.spec_from_file_location("tccc", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_port_config_field_is_consumed_or_allowlisted():
    r = subprocess.run([sys.executable, SCRIPT], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "config coverage OK" in r.stdout


def test_fields_come_from_the_port_config():
    import dataclasses
    from lightgbm_tpu_torch.config import Config
    assert _load().config_fields() == [
        f.name for f in dataclasses.fields(Config)]


def test_stale_allowlist_entry_fails(capsys):
    mod = _load()
    mod.ALLOWLIST["num_leaves"] = "pretend-inert (consumed everywhere)"
    assert mod.main() == 1
    out = capsys.readouterr().out
    assert "STALE ALLOWLIST" in out and "num_leaves" in out


def test_a_field_named_only_in_the_fingerprint_set_is_dead(tmp_path):
    """A package whose only mention of `telemetry_path` is the
    fingerprint exclusion set: the field is dead.  Read through
    config_from_params, it is consumed."""
    mod = _load()
    pkg = tmp_path / "pkg"
    (pkg / "boosting").mkdir(parents=True)
    (pkg / "config.py").write_text(textwrap.dedent("""
        class Config:
            telemetry_path: str = ""
            num_leaves: int = 31

        def config_from_params(params):
            return Config()
        """))
    (pkg / "boosting" / "gbdt.py").write_text(textwrap.dedent("""
        _FINGERPRINT_EXCLUDE = frozenset({
            "task",
            "telemetry_path",
        })

        def grow(cfg):
            return cfg.num_leaves
        """))
    fields = mod.config_fields(str(pkg / "config.py"))
    dead, stale = mod.check(fields, mod.consumed_blob(str(pkg)), {})
    assert dead == ["telemetry_path"] and stale == []
    (pkg / "config.py").write_text(textwrap.dedent("""
        class Config:
            telemetry_path: str = ""
            num_leaves: int = 31

        def config_from_params(params):
            cfg = Config()
            if cfg.telemetry_path:
                pass
            return cfg
        """))
    dead, _ = mod.check(fields, mod.consumed_blob(str(pkg)), {})
    assert dead == []


def test_consumption_ignores_comments_and_docstrings():
    mod = _load()
    code = mod._code_only(
        'x = 1  # the future cfg.fused_tree override\n'
        'y = getattr(cfg, "hist_rows", "auto")\n'
        'def f():\n'
        '    """line one.\\nmentions mesh_shape in prose."""\n'
        '    return 1\n')
    assert "fused_tree" not in code
    assert "mesh_shape" not in code
    assert "hist_rows" in code
