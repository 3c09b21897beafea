"""Run a `torch.distributed` world of W processes for the port's tests.

Each rank runs a worker script written to the test's tmp_path: it puts
the checkout on sys.path, joins a gloo world through a file store under
tmp_path (no port can clash between pytest-xdist workers), runs `body`
and leaves the world.  The processes are started and watched by
lightgbm_tpu_torch.diagnostics.worlds.run_world: every world has a time
limit, and when it runs out, or any rank exits non-zero, every rank
still running is killed and the test fails with the ranks' output (a
hung rank never reaches the suite's own limit).  No JAX is imported
here, so the card-only tests can use it."""
import os
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from lightgbm_tpu_torch.diagnostics.worlds import run_world as _run  # noqa: E402

_TEMPLATE = """\
import os, sys
sys.path.insert(0, {root!r})
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
STORE, OUT = sys.argv[3], sys.argv[4]
from lightgbm_tpu_torch.distributed import init_process_group
if {init!r}:
    DEVICE = init_process_group({backend!r}, RANK, WORLD, "file://" + STORE,
                                timeout_s={timeout})
{body}
import torch.distributed as dist
dist.destroy_process_group()
print("RANK_DONE", RANK, flush=True)
"""


def run_world(tmp_path, world: int, body: str, *, name: str = "world",
              timeout: float = 180.0, backend: str = "gloo",
              env: dict = None, init: bool = True) -> list:
    """Run `body` on every rank of a `world`-rank world; returns each
    rank's output.  `body` sees RANK, WORLD, OUT (a directory of
    tmp_path) and DEVICE (the rank's device name).  With init=False the
    body joins the world itself (STORE is the file store's path)."""
    out = tmp_path / f"{name}_out"
    out.mkdir(exist_ok=True)
    script = tmp_path / f"{name}_worker.py"
    script.write_text(_TEMPLATE.format(
        root=ROOT, backend=backend, timeout=timeout, init=init,
        body=textwrap.dedent(body)))
    store = tmp_path / f"{name}_store"
    if store.exists():
        store.unlink()
    penv = dict(os.environ)
    # no rank inherits a world or a JAX flag; each runs one OpenMP
    # thread unless the caller's environment says otherwise
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "XLA_FLAGS"):
        penv.pop(k, None)
    penv.setdefault("OMP_NUM_THREADS", "1")
    penv.update(env or {})
    argvs = [[sys.executable, str(script), str(r), str(world), str(store),
              str(out)] for r in range(world)]
    return _run(argvs, timeout=timeout, env=penv, log_dir=str(tmp_path),
                name=name)
