"""Start N ranks as spawned processes and run functions in them.

    with RankPool(2) as pool:
        results = pool.run(fn, arg)   # fn(arg) in every rank, results by rank
    RankPool(4, local_world_size=2)   # 4 ranks laid out as 2 nodes x 2

A :class:`RankPool` spawns its ranks once (``multiprocessing`` spawn start
method) and gives each the launcher's environment of ``torchrun``: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, and for
each :meth:`RankPool.run` the ``MASTER_PORT`` of a fresh rendezvous store
that the pool hosts for the run, as ``torchrun``'s agent does
(``TORCHELASTIC_USE_AGENT_STORE``), so the function can join a process group
(``parallel.mesh.init_distributed``) and leave it (``parallel.mesh.teardown``)
within one run. The store holds its port for the whole run: a port found free
and handed on could be taken by another pool in the meantime, and two pools
would then meet in one group. ``fn`` must be importable by
its module path (pickled by reference), and what it returns picklable.

A run that does not finish within its timeout, or in which a rank raises,
fails: the pool then stops every rank (a rank left waiting in a collective
would hang) and raises with each failing rank's traceback.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable

from torch.distributed import TCPStore


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, local_world: int, inbox, outbox) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank % local_world),
                      LOCAL_WORLD_SIZE=str(local_world), GROUP_RANK=str(rank // local_world),
                      MASTER_ADDR="127.0.0.1", TORCHELASTIC_USE_AGENT_STORE="True")
    while True:
        task = inbox.get()
        if task is None:
            return
        fn, args, port = task
        os.environ["MASTER_PORT"] = str(port)
        try:
            outbox.put((rank, True, fn(*args)))
        except BaseException:  # reported to the parent, which fails the run
            outbox.put((rank, False, traceback.format_exc()))


class RankPool:
    """``nprocs`` ranks, spawned once and reused by :meth:`run`.

    ``local_world_size``: the ranks of each node (all of them by default: one
    node); rank r is local rank ``r % local_world_size`` of node ``r //
    local_world_size``, as ``torchrun --nnodes`` numbers them. ``env``: extra
    environment variables for every rank."""

    def __init__(self, nprocs: int, env: dict | None = None, local_world_size: int | None = None):
        local_world_size = nprocs if local_world_size is None else local_world_size
        if nprocs < 1 or local_world_size < 1 or nprocs % local_world_size:
            raise ValueError(f"nprocs must be >= 1 and a multiple of local_world_size, got {nprocs} and "
                             f"{local_world_size}")
        ctx = multiprocessing.get_context("spawn")
        self.nprocs = nprocs
        self._inboxes = [ctx.Queue() for _ in range(nprocs)]
        self._outbox = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, nprocs, local_world_size, self._inboxes[r], self._outbox), daemon=True)
                       for r in range(nprocs)]
        # a spawned rank starts with this process's environment; ``env`` has to
        # be in it from the start, since a rank imports torch (which reads
        # OMP_NUM_THREADS, among others, once) before it runs any task
        saved = {k: os.environ.get(k) for k in env or {}}
        os.environ.update(env or {})
        try:
            for p in self._procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def run(self, fn: Callable, *args, timeout: float = 600.0) -> list[Any]:
        """``fn(*args)`` in every rank at once -> the return values by rank."""
        if self._procs is None:
            raise RuntimeError("the rank pool is closed")
        store = TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=timeout))
        for box in self._inboxes:
            box.put((fn, args, store.port))
        results: dict[int, Any] = {}
        failures: dict[int, str] = {}
        deadline = time.monotonic() + timeout
        dead: list[int] = []
        while len(results) + len(failures) < self.nprocs and time.monotonic() < deadline:
            try:
                rank, ok, val = self._outbox.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                if dead:
                    break
                continue
            (results if ok else failures)[rank] = val
            if failures:  # the others may wait for it in a collective: give them a little
                deadline = min(deadline, time.monotonic() + 30.0)
        if failures or len(results) < self.nprocs:
            missing = sorted(set(range(self.nprocs)) - set(results) - set(failures))
            self.close()
            msg = "".join(f"\n--- rank {r} ---\n{tb}" for r, tb in sorted(failures.items()))
            if dead:
                msg += f"\nranks {dead} exited"
            if missing:
                msg += f"\nranks {missing} did not finish within {timeout:.0f} s"
            raise RuntimeError(f"{getattr(fn, '__name__', fn)} failed in the rank pool:{msg}")
        return [results[r] for r in range(self.nprocs)]

    def close(self) -> None:
        """Stop every rank: ask, wait a little, then kill."""
        if self._procs is None:
            return
        for box, p in zip(self._inboxes, self._procs):
            if p.is_alive():
                box.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for box in (*self._inboxes, self._outbox):
            box.close()
            box.cancel_join_thread()
        self._procs = None

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

