"""Persistent scoring daemon on one CUDA card: kernels and weights loaded
once, reference views encoded once; the port's counterpart of
``crossscore_tpu/tasks/serve.py``.

    python -m crossscore_tpu_torch.tasks.serve \\
        trainer.ckpt_path_to_load=<lightning .ckpt | train run's ckpt/ dir> \\
        data.dataset.reference_dir=<dir> this_main.serve_port=8642 \\
        [this_main.serve_max_batch=8]

A run of the predict CLI pays process start, the checkpoint load and 1+K
backbone forwards per query (reference ``task/core.py:119-161``). The daemon
loads the CUDA kernels (``ops/_build.py``) and the weights once, encodes the
reference views through the frozen backbone once at startup (the
reference-token cache, ``data/token_cache.py``; restart-warm when
``this_main.ref_token_cache_dir`` is set), and a warm request then costs the
query's backbone forward and the decoder: K1 12, K2 12 and K3 4 launches per
dispatch, whatever its batch.

HTTP API (stdlib ``http.server``):

  GET  /healthz     -> JSON: status, reference count, token shape, the query
                       shapes run so far, request and dispatch counts. The
                       readiness probe: 503 while draining after SIGTERM.
  GET  /livez       -> 200 for as long as the process serves, through the
                       drain too: the liveness probe (the JAX daemon has only
                       /healthz, which a liveness probe reads as dead for the
                       whole drain).
  POST /score       -> body = PNG/JPEG image bytes. JSON ``{"mean_score",
                       "height", "width", "time_ms"}``; ``?map=npy`` returns
                       the float32 score map as ``.npy`` bytes, ``?map=png``
                       as a uint16 gray PNG (``metric_map_write``, reference
                       ``utils/io/images.py:32-63``).
  POST /score_path  -> JSON ``{"path": "..."}`` or ``{"paths": [...]}`` of
                       server-local files; JSON results in order.
  POST /reload      -> JSON ``{"ckpt": "..."}``: the weights hot-swapped. The
                       checkpoint loads on the host off the serving path; the
                       copy to the card, the references' re-encode and the
                       swap run under the dispatch lock; a failure keeps the
                       old weights.

Exactness: queries and references are trimmed to whole patches (%14) after
the short-side resize. The patch embedding ignores the sub-patch remainder,
so trimmed inputs give the predict CLI's tokens and score maps.

Shapes: the references must share one shape after the resize (one token
set). A query of another shape scores against it, the reference position
embedding pinned to the reference grid (``ref_grid``). The kernels take any
shape; the first dispatch at a new (h, w, bucket) is logged.

Graphs: on the card each (h, w, bucket) runs as one CUDA graph per replica,
the counterpart of the JAX daemon's compiled executable per key: a first
eager run (kernel loads, ``cudaFuncSetAttribute``, cuBLAS, the constants of
the static resizes), then a capture of the forward that reads a static query
buffer and the token set and writes static maps and means. A dispatch copies
the padded batch in, replays, and copies the outputs out under the lock. All
graphs share one memory pool: one runs at a time, and no graph's outputs are
read but right after its own replay. A capture or replay that fails raises;
there is no eager fallback on the card. On the CPU the daemon runs the same
keys eagerly. A reload copies the new weights and tokens into the captured
net's own tensors, so the graphs stay valid.

Artifacts (``io/aot.py``): ``this_main.serve_aot_save=<file>`` writes, after
the warm-up, every key captured so far (the loaded ones included) and the
kernel libraries; ``this_main.serve_aot_load=<file>`` checks an artifact
against this daemon and this card, installs its libraries into the build
directory (``ops/_build.py``; the CLI points it at
``$CROSSSCORE_COMPILE_CACHE`` through ``utils/compilation_cache.py``) before
the first kernel load, so that no ``nvcc`` runs, and warms and captures
every key it lists, in process like any other key: the artifact carries no
graph. ``this_main.serve_warmup_only=true`` with ``serve_aot_save`` is the
exporter: it warms, saves and exits.

Transfer: the per-frame mean is reduced on the card, so a JSON request
fetches one scalar; the map crosses only for ``?map=npy|png``.
``this_main.serve_upload_cast=true`` casts the queries to the compute dtype
on the host (numpy has no bf16: the cast makes a torch tensor), halving the
upload under bf16; the model casts its input to that dtype first, so the
scores are the same.

Throughput: ``this_main.serve_max_batch`` > 1 collects concurrent same-shape
requests for ``serve_batch_window_ms`` into one padded dispatch at a
power-of-two bucket; every bucket is warmed at startup.

Threads: the HTTP handlers decode and resize on their own threads. All device
work (dispatches, reference encodes, a reload's copy to the card) and the
kernels' launch counters sit under one lock, on the default stream.
"""

from __future__ import annotations

import copy
import json
import queue
import signal
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from crossscore_tpu_torch.data.token_cache import RefTokenCache
from crossscore_tpu_torch.io import aot
from crossscore_tpu_torch.io.images import image_read, image_read_bytes, metric_map_write, normalize_imagenet
from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
from crossscore_tpu_torch.ops import _build, interpolate
from crossscore_tpu_torch.ops.interpolate import resize_bilinear_antialias
from crossscore_tpu_torch.tasks.common import (
    load_model_params, parse_cli, refuse_multi_rank, refuse_tensor_parallel, resolve_accelerator,
)
from crossscore_tpu_torch.train.step import make_predict_step_cached
from crossscore_tpu_torch.utils import compilation_cache

# the kernels of the daemon's path: K1 (flash_qkv), K3 (flash_cross), K2 (fused_ln_mlp), and Q1/Q2
# (int8_linear) under model.gpu.backbone_quant=int8
KERNEL_SOURCES = ("flash_qkv", "flash_cross", "fused_ln_mlp", "int8_linear")


class ServerOverloaded(RuntimeError):
    """Raised when the pending-request queue is at ``serve_max_queue``; the
    HTTP layer maps it to 503, so a load balancer sheds to other replicas
    instead of piling latency onto this one."""


class _Inflight:
    """Context-manager request counter for the SIGTERM drain; ``bump`` makes
    it a plain counter."""

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def __enter__(self):
        with self._lock:
            self.value += 1
        return self

    def __exit__(self, *exc):
        with self._lock:
            self.value -= 1
        return False

    def bump(self):
        """One-way increment (plain counter use, no paired decrement)."""
        with self._lock:
            self.value += 1


class _Eager:
    """One (h, w, bucket)'s forward on one replica, run eagerly: the CPU's
    executable."""

    def __init__(self, forward, model, tokens, device):
        self.forward, self.model, self.tokens, self.device = forward, model, tokens, device

    def __call__(self, q: torch.Tensor):
        return self.forward(self.model, q.to(self.device), self.tokens)


class _Graph(_Eager):
    """One (h, w, bucket)'s forward on one replica captured as a CUDA graph:
    the card's executable. ``shape`` is the replica's part of the padded
    batch. The graph holds device addresses (the kernels' TMA descriptors
    among them): the static query buffer, the weights, the token set and the
    graph pool must never move, so weights and tokens are updated in place.
    It keeps the static resizes' constants (``ops/interpolate.py``) alive
    for as long as it lives."""

    def __init__(self, forward, model, tokens, device, shape, dtype, pool):
        super().__init__(forward, model, tokens, device)
        with torch.cuda.device(device):
            self.q = torch.zeros(shape, dtype=dtype, device=device)
            torch.cuda.reset_peak_memory_stats(device)
            forward(model, self.q, tokens)  # outside any capture: kernel loads, attributes, caches
            torch.cuda.synchronize(device)
            self.eager_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                self.maps, self.means = forward(model, self.q, tokens)
            self.capture_peak = torch.cuda.max_memory_allocated(device)
        self.constants = interpolate.constants()

    def __call__(self, q: torch.Tensor):
        with torch.cuda.device(self.device):
            self.q.copy_(q)
            self.graph.replay()
        return self.maps, self.means


class Scorer:
    """The model, the reference tokens and the cached predict step.

    Thread-safe: device work is serialised behind one lock (one card, one
    stream); preprocessing runs outside it.

    :param devices: the local devices of local data parallelism
        (``serve_local_dp``), the accelerator's first; default every local
        CUDA card (the CPU alone under ``trainer.accelerator=cpu``). A padded
        batch is split over the largest divisor of its bucket that is at most
        their count, one replica of the model and tokens on each."""

    def __init__(self, cfg, devices=None):
        device = resolve_accelerator(cfg)
        refuse_multi_rank(cfg)
        refuse_tensor_parallel(str(cfg.model.gpu.attention_impl))
        if devices is None:
            devices = [device] + [torch.device("cuda", i) for i in range(torch.cuda.device_count())
                                  if device.type == "cuda" and i != device.index]
        self._devices = [torch.device(d) for d in devices]
        if self._devices[0].type != device.type:
            raise ValueError(f"devices must start with the accelerator's ({device}), got {self._devices[0]}")
        self.device = device
        if device.type == "cuda":
            # full fp32 for fp32 products and convolutions (cuDNN defaults to TF32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        self.cfg = cfg
        self.resize_short = int(cfg.this_main.resize_short_side)
        self.metric_vrange = [cfg.model.predict.metric.min, cfg.model.predict.metric.max]
        ref_dir = cfg.data.dataset.reference_dir
        if not ref_dir:
            raise ValueError("serve requires data.dataset.reference_dir")
        ref_dir = Path(ref_dir).expanduser()
        ref_paths = sorted(str(p) for p in ref_dir.iterdir() if p.is_file())
        max_refs = int(cfg.this_main.get("serve_max_refs", 0))
        if max_refs > 0:
            ref_paths = ref_paths[:max_refs]
        if not ref_paths:
            raise ValueError(f"no reference images in {ref_dir}")

        t0 = time.perf_counter()
        refs = [self._preprocess(image_read(p)) for p in ref_paths]
        shapes = {r.shape for r in refs}
        if len(shapes) != 1:
            raise ValueError(
                f"reference images must share one post-resize shape for a single token batch; got "
                f"{sorted(shapes)} — split the dir per camera or set this_main.resize_short_side")
        self._ref_imgs = np.stack(refs)[None]  # (1, K, H, W, 3), kept for a reload's re-encode
        self._ref_paths = ref_paths
        self.n_refs = len(ref_paths)

        self._mcfg = CrossScoreConfig.from_config(cfg)
        self.model = load_model_params(cfg, CrossScoreNet(self._mcfg, device=device))
        self._in_dtype = (self._mcfg.compute_dtype if bool(cfg.this_main.get("serve_upload_cast", False))
                          else torch.float32)
        patch = self._mcfg.patch_size
        ref_h, ref_w = refs[0].shape[:2]
        self._ref_grid = (ref_h // patch, ref_w // patch)
        self.token_shape = (self.n_refs, self._ref_grid[0] * self._ref_grid[1], self._mcfg.backbone.hidden_size)
        self.startup_s = {"references": time.perf_counter() - t0}

        # an artifact's libraries go into the build directory before the
        # first build or load, so that no nvcc runs
        artifact_keys: list[tuple[int, int, int]] = []
        aot_load = cfg.this_main.get("serve_aot_load")
        if aot_load:
            t0 = time.perf_counter()
            _, entries, installed = aot.load_artifact(aot_load, expect_meta=self._artifact_meta(), device=device,
                                                      max_devices=len(self._devices))
            artifact_keys = [aot.parse_key(k) for k in entries]
            self.startup_s["artifact"] = time.perf_counter() - t0
            print(f"serve: loaded {len(entries)} graph keys from {aot_load}; {len(installed)} kernel libraries "
                  f"installed into {_build.build_dir()}", flush=True)

        t0 = time.perf_counter()
        self.kernels_built: list[str] = []  # the sources nvcc compiled in this process
        if device.type == "cuda":
            # one build and load before any thread dispatches
            self.kernels_built = sorted(_build.build_all(KERNEL_SOURCES))
            for name in KERNEL_SOURCES:
                _build.load(name)
        self.startup_s["kernels"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self._encoder = make_backbone_encoder(self._mcfg)
        self._encode_batch = int(cfg.this_main.get("ref_token_cache_encode_batch", 16))
        self.ckpt_path = cfg.trainer.ckpt_path_to_load
        self._lock = threading.Lock()
        cache = RefTokenCache(
            self._encode_fn(self.model),
            encode_batch=self._encode_batch,
            max_items=max(self.n_refs, int(cfg.this_main.get("ref_token_cache_max_items", 2048))),
            persist_dir=cfg.this_main.get("ref_token_cache_dir"),
        )
        with self._lock:
            self.tokens = cache.gather([[p] for p in ref_paths], self._ref_imgs).to(device)  # (1, K, N, D)
        self.disk_hits = cache.disk_hits
        self.startup_s["references"] += time.perf_counter() - t0

        self._serve_dp = bool(cfg.this_main.get("serve_local_dp", True))
        self._placed: dict[int, tuple] = {}  # split -> (the model it was made from, replicas)
        self.compiled_shapes: list[tuple[int, int, int]] = []  # (h, w, bucket) run so far
        # (h, w, bucket) -> one executable per replica: graphs on the card
        self._executables: dict[tuple[int, int, int], list] = {}
        self._pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self._aot_keys = set(artifact_keys)  # the keys the artifact listed (/healthz aot_shapes)
        self.graph_memory: dict = {}
        self.n_requests = 0
        self.n_dispatches = 0
        self.max_batch_seen = 0

        # micro-batching: bucket sizes are the powers of two up to the cap,
        # and the cap; every (shape, bucket) is warmed below
        self.max_batch = max(1, int(cfg.this_main.get("serve_max_batch", 1)))
        self.batch_window_s = float(cfg.this_main.get("serve_batch_window_ms", 2.0)) / 1e3
        # backpressure: a 503 instead of an unbounded queue (0 = unbounded)
        self.max_queue = int(cfg.this_main.get("serve_max_queue", 0))
        self._rejected = _Inflight()
        self._buckets = sorted({b for b in (1, 2, 4, 8, 16, 32) if b <= self.max_batch} | {self.max_batch})
        if self.max_batch > 1:
            self._queue: queue.Queue = queue.Queue(maxsize=self.max_queue)
            threading.Thread(target=self._dispatch_loop, daemon=True).start()

        # warm-up at the reference shape and at each serve_warm_shapes entry
        # ("HxW", post-resize and %14-trimmed), every bucket: the first request
        # pays no CUDA context, cuBLAS heuristics or kernel load. It is not
        # counted as served requests.
        t0 = time.perf_counter()
        warm = [refs[0].shape[:2]]
        for s in cfg.this_main.get("serve_warm_shapes") or []:
            h, w = (int(x) for x in str(s).lower().split("x"))
            if h % 14 or w % 14:
                raise ValueError(f"serve_warm_shapes entry {s!r} must be %14-trimmed "
                                 f"(post-resize shapes, e.g. '518x686')")
            warm.append((h, w))
        keys = [(h, w, b) for h, w in warm for b in self._buckets]
        keys += [k for k in artifact_keys if k not in keys]
        for h, w, b in keys:
            self._dispatch(torch.zeros((b, h, w, 3), dtype=self._in_dtype), b, want_map=(b == self._buckets[0]),
                           count=False)
        self.startup_s["warmup"] = time.perf_counter() - t0
        graphs = [g for execs in self._executables.values() for g in execs if isinstance(g, _Graph)]
        if graphs:
            self.graph_memory = {"eager_peak_gib": max(g.eager_peak for g in graphs) / 2**30,
                                 "capture_peak_gib": max(g.capture_peak for g in graphs) / 2**30,
                                 "resident_gib": torch.cuda.memory_allocated(device) / 2**30, "graphs": len(graphs)}

        aot_save = cfg.this_main.get("serve_aot_save")
        if aot_save:
            try:
                entries = {aot.key(*k): {"n_devices": len(execs)} for k, execs in self._executables.items()}
                libs = [_build.library_path(name) for name in KERNEL_SOURCES] if device.type == "cuda" else []
                aot.save_artifact(aot_save, entries, self._artifact_meta(), libs, device=device)
                print(f"serve: saved {len(entries)} graph keys and {len(libs)} kernel libraries to {aot_save}",
                      flush=True)
            except (OSError, ValueError) as e:  # the daemon serves without it, as the JAX one does
                print(f"serve: artifact save failed ({e}); continuing without it", flush=True)

    def _artifact_meta(self) -> dict:
        """The serving configuration an artifact is exported for and checked
        against (``io/aot.py``), beside its environment fields."""
        return {"token_shape": list(self.token_shape), "ref_grid": list(self._ref_grid),
                "params_signature": aot.params_signature(self.model.state_dict()),
                "in_dtype": str(self._in_dtype).removeprefix("torch."),
                "backbone_quant": self._mcfg.backbone_quant, "n_devices": len(self._devices)}

    # ------------------------------------------------------------ scoring

    def _encode_fn(self, model):
        """The token cache's ``encode(imgs, valid_hw=None)`` on ``model``."""
        def encode(imgs: np.ndarray, valid_hw=None) -> torch.Tensor:
            x = torch.from_numpy(np.ascontiguousarray(imgs)).to(model.img_mean_std.device)
            return self._encoder(model, x)

        return encode

    def _preprocess(self, img: np.ndarray) -> np.ndarray:
        """float32 [0,1] (H, W, 3) -> resized, %14-trimmed, ImageNet-normalised.

        The predict pipeline's rounding (``data/nvs_index.py::_resize``); the
        trim is output-exact (module docstring)."""
        s = self.resize_short
        h, w = img.shape[:2]
        if s > 0 and min(h, w) != s:
            if h <= w:
                h, w = s, max(1, round(w * s / h))
            else:
                h, w = max(1, round(h * s / w)), s
            img = resize_bilinear_antialias(img, h, w)
        if min(h, w) < 14:
            raise ValueError(f"image too small after resize: {(h, w)} — needs at least one 14px patch per "
                             f"side (this_main.resize_short_side={s})")
        img = img[: h - h % 14, : w - w % 14]
        return normalize_imagenet(img).astype(np.float32)

    def _forward(self, model, q: torch.Tensor, tokens: torch.Tensor):
        """(score maps, per-frame means) of queries ``q`` (B, H, W, 3) against
        the one token set (1, K, N, D), broadcast to the batch (a stride-0
        view; the position embedding's add materialises it)."""
        with torch.inference_mode():
            tok = tokens.expand(q.shape[0], *tokens.shape[1:])
            m = make_predict_step_cached(model)(q, tok, ref_grid=self._ref_grid)["score_map_ref_cross"]
            return m, m.mean(dim=(1, 2))

    def _replicas(self, bucket: int) -> list:
        """[(model, tokens, device)] a bucket runs on: one replica per part
        of the split under local data parallelism, else the model alone.
        Called under ``self._lock``: each split records the model it was
        made from and is rebuilt when ``self.model`` is another object, so a
        reload can never leave stale weights on a replica."""
        single = [(self.model, self.tokens, self.device)]
        if not self._serve_dp or len(self._devices) == 1 or bucket == 1:
            return single
        n = max(d for d in range(1, len(self._devices) + 1) if bucket % d == 0)
        if n == 1:
            return single
        entry = self._placed.get(n)
        if entry is None or entry[0] is not self.model:
            reps = single + [(copy.deepcopy(self.model).to(dev), self.tokens.to(dev), dev)
                             for dev in self._devices[1:n]]
            entry = self._placed[n] = (self.model, reps)
        return entry[1]

    def _run_device(self, qs: np.ndarray, want_map: bool, count: bool = True):
        """One padded device dispatch for (n, H, W, 3) preprocessed queries.
        Returns (maps or None, means) for the n rows, as numpy."""
        n = len(qs)
        bucket = min(b for b in self._buckets if b >= n)
        if n < bucket:  # pad by repeating the last query
            qs = np.concatenate([qs, np.broadcast_to(qs[-1:], (bucket - n, *qs.shape[1:]))])
        q = torch.from_numpy(np.ascontiguousarray(qs, np.float32))
        if self._in_dtype != torch.float32:
            q = q.to(self._in_dtype)  # on the host: the upload is in the compute dtype
        return self._dispatch(q, n, want_map, count)

    def _dispatch(self, q: torch.Tensor, n: int, want_map: bool, count: bool = True):
        """Run the executables of ``q``'s (h, w, bucket) on the padded host
        batch ``q``, capturing them at the key's first dispatch; the first
        ``n`` rows' (maps or None, means) as numpy."""
        key = (int(q.shape[1]), int(q.shape[2]), int(q.shape[0]))
        with self._lock:
            if key not in self.compiled_shapes:
                print(f"serve: first dispatch at query shape {key[:2]} bucket={key[2]} "
                      f"({len(self.compiled_shapes)} shapes before)", flush=True)
                self.compiled_shapes.append(key)
            outs = self._execute(key, q)
            means = torch.cat([mean.cpu() for _, mean in outs])[:n].numpy()  # small fetch = sync
            maps = torch.cat([m.cpu() for m, _ in outs])[:n].numpy() if want_map else None
            if count:
                self.n_requests += n
                self.n_dispatches += 1
                self.max_batch_seen = max(self.max_batch_seen, n)
        return maps, means

    def _execute(self, key: tuple[int, int, int], q: torch.Tensor) -> list:
        """[(maps, means)] of each replica's part of ``q``. Called under
        ``self._lock``. A key's executables are made again when the replicas
        they were made on are gone (a reload rebuilds split replicas)."""
        replicas = self._replicas(key[2])
        execs = self._executables.get(key)
        if execs is None or any(x.model is not model for x, (model, _, _) in zip(execs, replicas)):
            rows = (key[2] // len(replicas), key[0], key[1], 3)
            execs = self._executables[key] = [
                _Graph(self._forward, model, tokens, dev, rows, self._in_dtype, self._pool) if dev.type == "cuda"
                else _Eager(self._forward, model, tokens, dev) for model, tokens, dev in replicas]
        return [x(part) for x, part in zip(execs, q.chunk(len(replicas)))]

    class _Pending:
        __slots__ = ("q", "want_map", "event", "result", "error")

        def __init__(self, q, want_map):
            self.q, self.want_map = q, want_map
            self.event = threading.Event()
            self.result = self.error = None

    def _run_batch(self, batch: list) -> None:
        try:
            want_map = any(it.want_map for it in batch)
            maps, means = self._run_device(np.stack([it.q for it in batch]), want_map)
            for i, it in enumerate(batch):
                it.result = (maps[i] if it.want_map else None, float(means[i]))
        except Exception as e:  # deliver to every waiter; the loop survives
            for it in batch:
                it.error = e
        finally:
            for it in batch:
                it.event.set()

    def _dispatch_loop(self) -> None:
        """Drain concurrent requests into one padded dispatch: wait for the
        first item, then collect same-shape items for the batching window (or
        until the cap); a change of shape flushes the batch."""
        while True:
            batch = [self._queue.get()]
            deadline = time.perf_counter() + self.batch_window_s
            while len(batch) < self.max_batch:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt.q.shape != batch[0].q.shape:
                    self._run_batch(batch)
                    batch = [nxt]
                    deadline = time.perf_counter() + self.batch_window_s
                else:
                    batch.append(nxt)
            self._run_batch(batch)

    def _score_preprocessed(self, q: np.ndarray, want_map: bool = True):
        shape = q.shape[:2]
        if self.max_batch == 1:
            maps, means = self._run_device(q[None], want_map)
            return (maps[0] if want_map else None), float(means[0]), shape
        item = self._Pending(q, want_map)
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            self._rejected.bump()
            raise ServerOverloaded(f"pending queue at serve_max_queue={self.max_queue}; retry") from None
        item.event.wait()
        if item.error is not None:
            raise item.error
        score_map, mean = item.result
        return score_map, mean, shape

    def score(self, img: np.ndarray, want_map: bool = True) -> dict:
        """float32 [0,1] (H, W, 3) image -> per-frame mean (+ score map)."""
        t0 = time.perf_counter()
        score_map, mean, shape = self._score_preprocessed(self._preprocess(img), want_map)
        res = {"mean_score": mean, "height": int(shape[0]), "width": int(shape[1]),
               "time_ms": round(1e3 * (time.perf_counter() - t0), 2)}
        if want_map:
            res["score_map"] = score_map
        return res

    def score_bytes(self, data: bytes, want_map: bool = True) -> dict:
        return self.score(image_read_bytes(data), want_map)

    def score_path(self, path: str, want_map: bool = True) -> dict:
        return self.score(image_read(path), want_map)

    def reload(self, ckpt_path: str) -> dict:
        """Weight hot-swap: load ``ckpt_path`` (a ``.ckpt`` file or a train
        run's ``ckpt/`` dir, as the CLI flag) into a fresh net on the host,
        off the serving path; then, under the dispatch lock, copy it to the
        card, re-encode the reference tokens with it, and copy its weights
        and tokens into the served net's own tensors, which the graphs read.
        Requests serve the old weights until then. A failure before the copy
        keeps the old state. The card's peak memory over the locked part is
        reported."""
        if not ckpt_path:
            raise ValueError("reload needs a checkpoint path")
        t0 = time.perf_counter()
        old = self.cfg.trainer.ckpt_path_to_load
        self.cfg.trainer.ckpt_path_to_load = ckpt_path
        cuda = self.device.type == "cuda"
        try:
            model = load_model_params(self.cfg, CrossScoreNet(self._mcfg, device="cpu"))
            cache = RefTokenCache(self._encode_fn(model), encode_batch=self._encode_batch,
                                  max_items=max(self.n_refs, 1))
            with self._lock:
                if cuda:
                    torch.cuda.reset_peak_memory_stats(self.device)
                model.to(self.device)
                tokens = cache.gather([[p] for p in self._ref_paths], self._ref_imgs).to(self.device)
                peak = torch.cuda.max_memory_allocated(self.device) / 2**30 if cuda else None
                # in place: the captured graphs read these tensors
                self.model.load_state_dict(model.state_dict())
                with torch.inference_mode():
                    self.tokens.copy_(tokens)
                self.ckpt_path = ckpt_path
                self._placed.clear()  # replicas are rebuilt at the next split dispatch
        except Exception:
            self.cfg.trainer.ckpt_path_to_load = old
            raise
        return {"status": "reloaded", "ckpt": str(ckpt_path), "seconds": round(time.perf_counter() - t0, 2),
                "peak_memory_gib": peak}

    def health(self) -> dict:
        with self._lock:  # a consistent snapshot against dispatches and reloads
            return {
                "status": "ok",
                "ckpt": None if self.ckpt_path is None else str(self.ckpt_path),
                "refs": self.n_refs,
                "token_shape": list(self.token_shape),
                "compiled_shapes": [list(s) for s in self.compiled_shapes],
                "requests": self.n_requests,
                "dispatches": self.n_dispatches,
                "max_batch": self.max_batch,
                "max_batch_seen": self.max_batch_seen,
                "rejected_503": self._rejected.value,
                "restart_warm_disk_hits": self.disk_hits,
                "aot_shapes": len(self._aot_keys),
                "local_devices": len(self._devices),
                "local_dp_meshes": sorted(self._placed),
                "backend": self.device.type,
            }


def _json_result(res: dict) -> dict:
    return {k: v for k, v in res.items() if k != "score_map"}


def make_server(cfg, devices=None):
    """Build (ThreadingHTTPServer, Scorer); the caller runs serve_forever."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    scorer = Scorer(cfg, devices)
    max_body = int(float(cfg.this_main.get("serve_max_body_mb", 64)) * 1024 * 1024)
    # SIGTERM drain state (install_sigterm_drain): once `draining` is set, new
    # work gets a typed 503 while requests already inside the `inflight`
    # counter run to completion
    draining = threading.Event()
    inflight = _Inflight()
    drain_rejected = _Inflight()  # .value counts 503'd post-drain requests

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # stdout, one line, no reverse DNS
            print(f"serve: {self.address_string()} {fmt % args}", flush=True)

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/livez":
                # liveness: 200 through the drain, so a probe on it does not
                # kill the replica before its accepted requests finish
                self._send_json(200, {"status": "draining" if draining.is_set() else "alive"})
            elif path == "/healthz":
                h = scorer.health()
                if draining.is_set():
                    # readiness: a non-2xx status pulls the replica from
                    # rotation; the body keeps the stats
                    h["status"] = "draining"
                    self._send_json(503, h)
                else:
                    self._send_json(200, h)
            else:
                self._send_json(404, {"error": f"unknown path {self.path}"})

        def _respond_scored(self, res: dict, map_mode: str) -> None:
            if map_mode == "npy":
                import io as _io

                buf = _io.BytesIO()
                np.save(buf, res["score_map"])
                self._send(200, buf.getvalue(), "application/octet-stream")
            elif map_mode == "png":
                with tempfile.NamedTemporaryFile(suffix=".png") as f:
                    metric_map_write(f.name, res["score_map"], scorer.metric_vrange)
                    self._send(200, Path(f.name).read_bytes(), "image/png")
            else:
                self._send_json(200, _json_result(res))

        def do_POST(self):
            # enter the counter FIRST, then check: a request counted before
            # the drain began completes (the drain waits on the counter); one
            # entering after gets the typed 503
            with inflight:
                if draining.is_set():
                    drain_rejected.bump()
                    self.close_connection = True
                    self._send_json(503, {"error": "ServerDraining: SIGTERM received; this replica is "
                                                   "shutting down"})
                    return
                self._do_post_inner()

        def _do_post_inner(self):
            url = urlparse(self.path)
            map_mode = parse_qs(url.query).get("map", ["none"])[0]
            try:
                n_body = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self.close_connection = True
                self._send_json(400, {"error": "BadRequest: non-numeric Content-Length header"})
                return
            if n_body < 0:
                # rfile.read(-1) would block until the client closes
                self.close_connection = True
                self._send_json(400, {"error": "BadRequest: negative Content-Length header"})
                return
            if max_body and n_body > max_body:
                # a typed 4xx BEFORE the body is read or decoded; the unread
                # body makes the connection unusable, so it is closed
                self.close_connection = True
                self._send_json(413, {"error": f"PayloadTooLarge: body is {n_body} bytes; the daemon caps "
                                               f"requests at serve_max_body_mb={max_body // (1024 * 1024)}"})
                return
            try:
                body = self.rfile.read(n_body)
                want_map = map_mode in ("npy", "png")
                if url.path == "/score":
                    self._respond_scored(scorer.score_bytes(body, want_map), map_mode)
                elif url.path == "/reload":
                    self._send_json(200, scorer.reload(json.loads(body).get("ckpt")))
                elif url.path == "/score_path":
                    req = json.loads(body)
                    paths = req.get("paths", [req["path"]] if "path" in req else [])
                    if not paths:
                        raise ValueError("score_path needs 'path' or 'paths'")
                    self._send_json(200, [dict(_json_result(scorer.score_path(p, want_map=False)), path=p)
                                          for p in paths])
                else:
                    self._send_json(404, {"error": f"unknown path {url.path}"})
            except ServerOverloaded as e:
                self._send_json(503, {"error": f"ServerOverloaded: {e}"})
            except Exception as e:  # surface the cause to the client
                self._send_json(400, {"error": f"{type(e).__name__}: {e}"})

    host = str(cfg.this_main.get("serve_host", "127.0.0.1"))
    port = int(cfg.this_main.get("serve_port", 8642))
    server = ThreadingHTTPServer((host, port), Handler)
    server.draining = draining
    server.inflight = inflight
    server.drain_rejected = drain_rejected
    server.drain_deadline_s = float(cfg.this_main.get("serve_drain_deadline_s", 30))
    server.drain_clean = None
    return server, scorer


def install_sigterm_drain(server) -> None:
    """SIGTERM -> graceful drain; SIGINT keeps KeyboardInterrupt behaviour.

    The handler flips the drain flag and starts a side thread that waits for
    the in-flight requests (:func:`drain_server`, at most
    ``server.drain_deadline_s``) and then stops the accept loop. Until then
    the listener stays open: post-drain requests get the typed 503, /healthz
    503 and /livez 200 (the JAX daemon closes the listener at once, so
    probes and queued clients meet a closed port during its drain).
    ``shutdown()`` blocks until ``serve_forever`` acknowledges, so it runs on
    the side thread, never in the signal handler. Call from the main thread
    (a ``signal`` module rule)."""

    def _drain_then_stop():
        server.drain_clean = drain_server(server, server.drain_deadline_s)
        server.shutdown()

    def _on_sigterm(signum, frame):
        if not server.draining.is_set():
            server.draining.set()
            threading.Thread(target=_drain_then_stop, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_sigterm)


def drain_server(server, deadline_s: float = 30.0) -> bool:
    """Wait for in-flight requests to complete; True iff drained clean."""
    t0 = time.monotonic()
    while server.inflight.value > 0 and time.monotonic() - t0 < deadline_s:
        time.sleep(0.02)
    return server.inflight.value == 0


def serve(cfg) -> None:
    compilation_cache.enable()
    if bool(cfg.this_main.get("serve_warmup_only", False)):
        # load the kernels, encode the references (filling the token store
        # when ref_token_cache_dir is set), warm every shape, exit
        scorer = Scorer(cfg)
        print(f"serve: warmup-only done — {len(scorer.compiled_shapes)} shapes warmed, {scorer.n_refs} "
              f"references encoded ({scorer.disk_hits} from the token store); kernels built: "
              f"{', '.join(scorer.kernels_built) or 'none'}", flush=True)
        return
    server, scorer = make_server(cfg)
    install_sigterm_drain(server)
    host, port = server.server_address[:2]
    s = scorer.startup_s
    artifact = f"artifact {s['artifact']:.2f} s, " if "artifact" in s else ""
    print(f"serve: ready on http://{host}:{port} — {scorer.n_refs} references warm, token shape "
          f"{scorer.token_shape}, backend {scorer.device.type}; startup: {artifact}kernels {s['kernels']:.2f} s "
          f"(built: {', '.join(scorer.kernels_built) or 'none'}), references {s['references']:.2f} s, warm-up "
          f"{s['warmup']:.2f} s", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    if server.draining.is_set():
        h = scorer.health()
        state = ("complete" if server.drain_clean else
                 f"deadline {server.drain_deadline_s}s hit, {server.inflight.value} still in flight")
        print(f"serve: SIGTERM drain {state} — {h['requests']} requests, {h['dispatches']} dispatches, "
              f"{server.drain_rejected.value} drain-refused 503 (overload 503s over the run: "
              f"{h['rejected_503']})", flush=True)
    server.server_close()


def main(argv=None):
    serve(parse_cli("default_predict", argv))


if __name__ == "__main__":
    main()
