"""Concurrent load bench for the scoring daemon (``tasks/serve.py``); the
port's copy of ``tools/serve_load_bench.py``.

Fires N worker threads, each posting the same image M times through
``crossscore_tpu_torch.client.ScoreClient``, and reports throughput, latency
percentiles and the daemon's own dispatch statistics (how well
micro-batching coalesced). Works against any running daemon: one on the CPU
(``trainer.accelerator=cpu``) or on a card.

    python -m crossscore_tpu_torch.tools.serve_load_bench --url http://127.0.0.1:8642 \\
        --image path/to/render.png --workers 8 --requests 16
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

from crossscore_tpu_torch.client import ScoreClient


def run(url: str, body: bytes, workers: int, requests: int, want_map: bool = False) -> dict:
    """``workers`` threads, each posting ``body`` ``requests`` times, started
    together after one untimed warm request. Returns requests_ok, errors
    (with up to five messages), wall_s, throughput_rps, latency_ms (p50, p95,
    p99, max) and the daemon's request and dispatch counts over the run
    (``/healthz`` before and after; the warm request included)."""
    client = ScoreClient(url)
    h0 = client.health()
    client.score(body)  # a first request at a cold shape would bill its setup to one worker

    lat: list[float] = []
    errors: list[str] = []
    lock = threading.Lock()
    barrier = threading.Barrier(workers)

    def worker():
        barrier.wait()
        for _ in range(requests):
            t0 = time.perf_counter()
            try:
                client.score_map(body) if want_map else client.score(body)
            except Exception as e:  # keep the run going; report at the end
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")
                continue
            with lock:
                lat.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=worker) for _ in range(workers)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    h1 = client.health()
    lat.sort()
    n = len(lat)

    def pct(p: float) -> float | None:
        return lat[min(n - 1, int(p * n))] * 1e3 if n else None

    return {
        "workers": workers,
        "requests_per_worker": requests,
        "requests_ok": n,
        "errors": len(errors),
        "error_messages": errors[:5],
        "wall_s": wall,
        "throughput_rps": n / wall if wall > 0 else None,
        "latency_ms": {"p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99), "max": pct(1.0)},
        "daemon": {
            "requests": h1["requests"] - h0["requests"],
            "dispatches": h1["dispatches"] - h0["dispatches"],
            "max_batch_seen": h1["max_batch_seen"],
            "backend": h1["backend"],
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Concurrent load bench for the scoring daemon.")
    ap.add_argument("--url", default="http://127.0.0.1:8642")
    ap.add_argument("--image", required=True, help="query image file")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--requests", type=int, default=16, help="per worker")
    ap.add_argument("--map", action="store_true", help="fetch full npy maps")
    args = ap.parse_args(argv)
    res = run(args.url, Path(args.image).read_bytes(), args.workers, args.requests, args.map)
    print(json.dumps({k: v for k, v in res.items() if k != "error_messages"}))
    for e in res["error_messages"]:
        print(f"error: {e}", file=sys.stderr)
    return 1 if res["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
