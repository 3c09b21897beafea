"""Ingestion benchmark of the port: streamed (out-of-core) against
monolithic dataset construction.  Prints ONE JSON line and, with
BENCH_INGEST_OUT set, writes it to that file.  The port's version of
scripts/bench_ingest.py.

The claim under test (lightgbm_tpu_torch/sharded/ingest.py): the peak
host memory of `Dataset.from_stream` is bounded by `stream_chunk_rows`
plus the one-byte-a-cell binned store, not by the raw [N, F] float64
matrix that the monolithic construction holds.  Each configuration runs
in a process of its own, so `ru_maxrss` (a process's high-water mark) is
that configuration's peak.  The peak is read after the imports too, and
the comparisons take the construction's rise above that floor
(`ingest_rss_mb`): importing torch maps several GB on a CUDA host, which
would otherwise hide the difference.  The matrix crosses two lengths
with two chunk sizes:

- monolithic at N and at 4N: the peak grows about linearly with N;
- streamed at N and at 4N: the peak stays about flat (chunk + store);
- streamed with a small and a large chunk at 4N: the chunk moves the
  peak, N does not.

Rows are counter-based (row i is a pure function of i, no sequential
RNG), so every configuration sees the same values at any chunking, and
the streamed store is held sha1-equal to the monolithic one at N (within
the bin-construction sample budget, where the sketch pass is exact).
BENCH_SANITIZE=1 then trains a few iterations on a streamed store under
HotPathSanitizer on BENCH_DEVICE (the card by default): after warm-up, 0
kernel builds and 0 implicit transfers.

    BENCH_INGEST_ROWS        base N (default 200_000)
    BENCH_STREAM_CHUNK_ROWS  the small chunk (default 8192)
    BENCH_INGEST_OUT         output path (unset: print only)
    BENCH_DEVICE             device of the sanitized training (cuda)

    python scripts/bench_torch_ingest.py
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_BASE = int(os.environ.get("BENCH_INGEST_ROWS", 200_000))
CHUNK_SMALL = int(os.environ.get("BENCH_STREAM_CHUNK_ROWS", 8192))
CHUNK_LARGE = max(CHUNK_SMALL * 8, 65536)
F = 28
SANITIZE = os.environ.get("BENCH_SANITIZE", "0") not in ("0", "", "false")
DEVICE = os.environ.get("BENCH_DEVICE", "cuda")


def gen_rows(lo: int, hi: int, f: int = F):
    """Rows [lo, hi) as a pure function of the row index (Box-Muller on
    two counter-hashed uniforms): the same values under any chunking,
    so the streamed and monolithic constructions see the same data
    without either holding more than its own chunk."""
    import numpy as np
    i = np.arange(lo, hi, dtype=np.float64)[:, None]
    j = np.arange(f, dtype=np.float64)[None, :]
    u1 = np.modf(np.sin(i * 12.9898 + j * 78.233) * 43758.5453)[0] % 1.0
    u2 = np.modf(np.sin(i * 39.3461 + j * 11.135) * 24634.6345)[0] % 1.0
    u1 = np.abs(u1).clip(1e-12, 1 - 1e-12)
    X = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * np.abs(u2))
    w = np.sin(np.arange(f) * 0.7 + 0.3) / np.sqrt(f)
    noise = np.sqrt(-2.0 * np.log(np.abs(np.modf(
        np.sin(i[:, 0] * 7.13 + 3.7) * 15731.743)[0]).clip(1e-12, 1))) \
        * np.cos(2.0 * np.pi * i[:, 0] * 0.618)
    y = (X @ w + 0.5 * noise > 0).astype(np.float64)
    return X, y


def chunk_stream(rows: int, chunk: int):
    """A re-iterable chunk source (from_stream makes two passes)."""
    def chunks():
        for lo in range(0, rows, chunk):
            yield gen_rows(lo, min(lo + chunk, rows))
    return chunks


def _peak_rss_mb() -> float:
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def worker(mode: str, rows: int, chunk: int) -> None:
    """One configuration in a fresh process; prints its own JSON."""
    import hashlib
    import numpy as np
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.dataset import Dataset

    cfg = config_from_params({"verbose": -1, "stream_chunk_rows": chunk,
                              "device_type": "cpu"})
    base = _peak_rss_mb()
    t0 = time.perf_counter()
    if mode == "monolithic":
        X, y = gen_rows(0, rows)
        ds = Dataset(X, y.astype(np.float32), cfg)
        bins, n = ds.bins, ds.num_data
    else:
        ds = Dataset.from_stream(chunk_stream(rows, chunk), cfg)
        bins, n = ds.bins[:, : ds.num_data], ds.num_data
    dt = time.perf_counter() - t0
    print(json.dumps({
        "mode": mode, "rows": int(n), "chunk_rows": chunk,
        "ingest_seconds": round(dt, 3),
        "peak_rss_mb": round(_peak_rss_mb(), 1),
        "ingest_rss_mb": round(_peak_rss_mb() - base, 1),
        "bins_sha1": hashlib.sha1(
            np.ascontiguousarray(bins).tobytes()).hexdigest()[:16],
    }))


def run_config(mode: str, rows: int, chunk: int) -> dict:
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker", mode,
         str(rows), str(chunk)],
        capture_output=True, text=True, timeout=3600)
    if r.returncode != 0:
        raise RuntimeError(f"worker {mode}/{rows}/{chunk} failed:\n"
                           f"{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def sanitized_training(rows: int = 50_000, iters: int = 7) -> dict:
    """A few iterations of the rounds learner on a streamed store under
    HotPathSanitizer (warm-up 2 iterations, then every iteration
    guarded)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.capi import _wrap_inner
    from lightgbm_tpu_torch.config import config_from_params
    from lightgbm_tpu_torch.dataset import Dataset
    from lightgbm_tpu_torch.diagnostics.sanitize import HotPathSanitizer
    params = {"objective": "binary", "verbose": -1, "num_leaves": 31,
              "tree_growth": "rounds", "device_type": DEVICE,
              "stream_chunk_rows": CHUNK_SMALL}
    inner = Dataset.from_stream(chunk_stream(rows, CHUNK_SMALL),
                                config_from_params(params)).compacted()
    bst = lt.Booster(params, _wrap_inner(inner, params))
    san = HotPathSanitizer(warmup=2, label="ingest/streamed")
    with san:
        for _ in range(iters):
            with san.step():
                bst.update()
    out = san.report()
    out["trees"] = bst.num_trees()
    out["host_syncs_per_tree"] = list(bst._gbdt.host_syncs_per_tree)
    return out


def main() -> None:
    results = {
        "monolithic_n1": run_config("monolithic", N_BASE, CHUNK_SMALL),
        "monolithic_n4": run_config("monolithic", 4 * N_BASE, CHUNK_SMALL),
        "stream_small_n1": run_config("stream", N_BASE, CHUNK_SMALL),
        "stream_small_n4": run_config("stream", 4 * N_BASE, CHUNK_SMALL),
        "stream_large_n4": run_config("stream", 4 * N_BASE, CHUNK_LARGE),
    }
    # within the sample budget (N_BASE <= bin_construct_sample_cnt) the
    # streamed store is the monolithic one; past it the streamed mappers
    # come from the sketches and the monolithic ones from a row sample,
    # so the 4N stores are recorded, not compared
    same_n1 = (results["stream_small_n1"]["bins_sha1"]
               == results["monolithic_n1"]["bins_sha1"])
    rise = {k: r["ingest_rss_mb"] for k, r in results.items()}
    mono_growth = rise["monolithic_n4"] / max(rise["monolithic_n1"], 1.0)
    stream_growth = (rise["stream_small_n4"]
                     / max(rise["stream_small_n1"], 1.0))
    saving = rise["monolithic_n4"] / max(rise["stream_small_n4"], 1.0)
    out = {
        "metric": f"streamed-vs-monolithic ingestion, {N_BASE}x{F} and "
                  f"{4 * N_BASE}x{F}, chunks {CHUNK_SMALL}/{CHUNK_LARGE}",
        "results": results,
        "stream_equals_monolithic_n1": same_n1,
        "monolithic_rss_growth_n1_to_n4": round(mono_growth, 2),
        "streamed_rss_growth_n1_to_n4": round(stream_growth, 2),
        "streamed_vs_monolithic_rss_at_n4": round(saving, 2),
    }
    if SANITIZE:
        out["sanitize"] = sanitized_training()
    print(json.dumps(out))
    out_path = os.environ.get("BENCH_INGEST_OUT", "")
    if out_path:
        with open(out_path if os.path.isabs(out_path)
                  else os.path.join(ROOT, out_path), "w") as f:
            json.dump(out, f, indent=1)
    # the gates, after the JSON is out
    assert same_n1, "the streamed store differs from the monolithic one"
    assert stream_growth < mono_growth, (
        f"streamed RSS grew {stream_growth:.2f}x from N to 4N, monolithic "
        f"{mono_growth:.2f}x: streaming does not bound the peak")
    assert saving >= 1.5, (
        f"streamed RSS rise only {saving:.2f}x below monolithic at 4N")
    if SANITIZE:
        san = out["sanitize"]
        assert san["retraces_after_warmup"] == 0, san
        assert san["implicit_transfers"] == 0, san


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        main()
