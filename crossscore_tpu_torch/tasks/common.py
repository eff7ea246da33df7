"""Shared task-entry plumbing: CLI parsing, run and output dirs, weights,
bucketed-output crops, logging, the accelerator rule and the CLIs' data
ranks; the port's counterpart of ``crossscore_tpu/tasks/common.py``."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from datetime import datetime
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import yaml

from crossscore_tpu_torch.confsys import Config, load_config
from crossscore_tpu_torch.data import fastimage
from crossscore_tpu_torch.data.bucketing import ShapeBucketedLoader
from crossscore_tpu_torch.data.loader import Loader
from crossscore_tpu_torch.data.nvs_index import leaf_datasets
from crossscore_tpu_torch.data.token_cache import RefTokenCache
from crossscore_tpu_torch.device import resolve_device
from crossscore_tpu_torch.io.checkpoint import latest_step, step_path
from crossscore_tpu_torch.io.convert import init_params, load_into
from crossscore_tpu_torch.parallel import mesh
from crossscore_tpu_torch.parallel.collectives import all_reduce


def tristate(value) -> str:
    """Normalise an on|off|auto config knob. CLI overrides parse with YAML
    scalar semantics, so ``key=on`` arrives as True and ``key=off`` as False
    (YAML 1.1 booleans): compare through this, never against raw strings."""
    if value is True:
        return "on"
    if value is False:
        return "off"
    return str(value).lower()


def parse_cli(config_name: str, argv: Optional[list[str]] = None) -> Config:
    """Hydra-style CLI: every argument is a ``key.sub=value`` override (or
    ``group=choice`` to swap a config group; ``--help`` prints the composed
    config)."""
    argv = sys.argv[1:] if argv is None else argv
    if any(a in ("--help", "-h", "help") for a in argv):
        cfg = load_config(config_name, overrides=[a for a in argv if "=" in a])
        print(f"usage: override any key below as key.sub=value (root config: {config_name}.yaml)\n")
        print(yaml.safe_dump(cfg.to_dict(), sort_keys=False))
        sys.exit(0)
    return load_config(config_name, overrides=argv)


def timestamp() -> str:
    return datetime.now().strftime("%Y%m%d_%H%M%S.%f")


def resolve_limit(limit, batches_per_epoch: int) -> Optional[int]:
    """Lightning limit_*_batches semantics: int = number of batches,
    float = fraction of the epoch (1.0 = everything)."""
    if isinstance(limit, bool):
        raise ValueError(f"invalid limit {limit!r}")
    if isinstance(limit, int):
        return int(limit)
    if isinstance(limit, float):
        return None if limit >= 1.0 else int(limit * batches_per_epoch)
    return None


def confirm_batch_size(cfg: Config, loader_key: str = "validation") -> None:
    """Full-resolution images at a large batch can exhaust device memory; the
    reference asks on stdin (``task/predict.py:27-45``). Prompt only when
    interactive, otherwise warn and proceed (``this_main.force_batch_size=true``
    silences it)."""
    bs = cfg.data.loader[loader_key].batch_size
    if cfg.this_main.force_batch_size or bs <= 8 or cfg.this_main.crop_mode is not None:
        return
    msg = (f"Running full image resolution with batch_size={bs}. "
           "Press Enter to continue, or enter a new batch size: ")
    if sys.stdin is not None and sys.stdin.isatty():
        tmp = input(msg)
        if tmp.strip():
            if not tmp.strip().isdigit():
                raise ValueError("Invalid input")
            cfg.data.loader[loader_key].batch_size = int(tmp)
            print(f"Set batch size to {tmp}")
    else:
        print(f"WARNING: {msg} (non-interactive; proceeding)")


def resolve_out_dir(cfg: Config, phase: str) -> Path:
    """Reference semantics (``task/predict.py:47-65``): the output dir derives
    from the checkpoint's location, or is a fresh ``log/<ts>`` tree when no
    checkpoint is given; the composed config is saved into it."""
    if cfg.trainer.ckpt_path_to_load is None:
        log_dir = Path("log") / timestamp() / f"{phase}_empty_ckpt"
    else:
        log_dir = Path(cfg.trainer.ckpt_path_to_load).parents[1] / phase
    log_dir.mkdir(parents=True, exist_ok=True)
    if cfg.logger[phase].out_dir is None:
        out_dir = log_dir / timestamp()
        if cfg.alias:
            out_dir = Path(str(out_dir) + f"_{cfg.alias}")
        cfg.logger[phase].out_dir = str(out_dir)
    out_dir = Path(cfg.logger[phase].out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    save_config_snapshot(cfg, out_dir)
    return out_dir


def load_model_params(cfg: Config, model: torch.nn.Module) -> torch.nn.Module:
    """Load ``trainer.ckpt_path_to_load`` into ``model`` and return it:

    - a ``.ckpt`` file: a reference Lightning checkpoint or one written by the
      train CLI (``model.``-prefixed ``state_dict``);
    - a directory: the train CLI's ``ckpt/`` dir, whose latest
      ``step_<N>.ckpt`` is used (the reference points test/predict at one
      checkpoint the same way, ``task/test.py:134``);
    - null: seeded random weights (``io/convert.py::init_params``), with a
      loud warning.

    Checkpoints are read with ``weights_only=True``: tensors and plain
    containers only."""
    ckpt = cfg.trainer.ckpt_path_to_load
    device = model.img_mean_std.device
    if ckpt is None:
        print("WARNING: no checkpoint given (trainer.ckpt_path_to_load=null); using RANDOM weights.")
        return load_into(model, init_params(model.cfg, cfg.seed, device))
    ckpt = Path(ckpt)
    if ckpt.is_dir():
        step = latest_step(ckpt)
        if step is None:
            raise FileNotFoundError(f"no step_<N>.ckpt in {ckpt}")
        ckpt = step_path(ckpt, step)
    blob = torch.load(ckpt, map_location=device, weights_only=True)
    return load_into(model, blob.get("state_dict", blob))


def eval_loader(cfg: Config, dataset, cli: str, split: Optional[dict] = None):
    """The predict and test CLIs' loader over ``dataset`` in order -> (loader,
    whether it buckets shapes, :func:`use_shape_buckets`). A bucketed loader
    pads each item to multiples of ``bucket_multiple``.
    ``split``: the loader's node shard and rank block
    (:meth:`DataRanks.loader_kw`; none: every batch whole)."""
    use_buckets, n_shapes = use_shape_buckets(cfg, dataset)
    loader_kw = dict(
        batch_size=cfg.data.loader.validation.batch_size,
        num_workers=cfg.data.loader.validation.num_workers,
        prefetch_batches=cfg.data.loader.validation.prefetch_factor,
        seed=cfg.seed,
        **(split or {}),
    )
    if not use_buckets:
        return Loader(dataset, shuffle=False, **loader_kw), False
    loader = ShapeBucketedLoader(dataset, bucket_multiple=int(cfg.this_main.get("bucket_multiple", 112)),
                                 **loader_kw)
    print(f"shape-bucketed {cli}: {n_shapes} item shapes -> {len(loader.distinct_buckets())} bucket shape(s)")
    return loader, True


def use_shape_buckets(cfg: Config, dataset) -> tuple[bool, int]:
    """``this_main.shape_buckets`` on|off|auto over ``dataset`` -> (whether to
    bucket, the number of item shapes read, 0 when none were): never under
    the dataset's own crop, and under ``auto`` only when the items have more
    than one shape (padding one shape buys nothing)."""
    bucket_mode = tristate(cfg.this_main.get("shape_buckets", "auto"))
    if bucket_mode == "off" or cfg.this_main.crop_mode == "dataset_default":
        return False, 0
    shapes = {dataset.get_item_shape(i) for i in range(len(dataset))}
    return bucket_mode == "on" or len(shapes) > 1, len(shapes)


def ref_token_cache(cfg: Config, encode) -> RefTokenCache:
    """The predict and test CLIs' reference-token cache around
    ``encode(imgs, valid_hw=None)``, sized and persisted by
    ``this_main.ref_token_cache_{encode_batch,max_items,dir}``."""
    return RefTokenCache(
        encode,
        encode_batch=int(cfg.this_main.get("ref_token_cache_encode_batch", 16)),
        max_items=int(cfg.this_main.get("ref_token_cache_max_items", 2048)),
        persist_dir=cfg.this_main.get("ref_token_cache_dir"),
    )


def set_decode_skip(dataset, cache: RefTokenCache, *, query: bool) -> bool:
    """Set ``cache.has`` as the reference decode-skip hook (and the query's
    too when ``query``) on every leaf of ``dataset``, when the native decoder
    is present (the skip is the fused path's) -> whether it was set. A
    skipped image arrives as placeholder pixels with its ``*/skipped`` flag,
    and ``cache.gather(..., skipped=)`` resolves it."""
    if not fastimage.available():
        return False
    for leaf in leaf_datasets(dataset):
        leaf.ref_pixel_skip = cache.has
        if query:
            leaf.query_pixel_skip = cache.has
    return True


def crop_bucketed(batch: dict, outputs: dict) -> tuple[dict, dict]:
    """Crop bucket-padded batch arrays and model outputs back to the item's
    true shape for writers, visualisers and summarisers; a no-op without
    ``_valid_hw`` (data/bucketing.py). Images crop to (h, w), score maps to
    the jigsaw extent (h//14*14, w//14*14), attention-weight maps to the valid
    patch grid."""
    vhw = batch.get("_valid_hw")
    if vhw is None:
        return batch, outputs
    h, w = int(vhw[0]), int(vhw[1])
    ch, cw = h // 14 * 14, w // 14 * 14
    gh, gw = h // 14, w // 14
    b2 = dict(batch)
    for k in ("query/img", "reference/cross/imgs"):
        if k in b2 and b2[k] is not None:
            b2[k] = np.asarray(b2[k])[..., :h, :w, :]
    if "query/score_map" in b2:
        b2["query/score_map"] = np.asarray(b2["query/score_map"])[..., :ch, :cw]
    o2 = dict(outputs)
    if "score_map_ref_cross" in o2:
        o2["score_map_ref_cross"] = np.asarray(o2["score_map_ref_cross"])[:, :ch, :cw]
    if "attn_weights_map_ref_cross" in o2:
        o2["attn_weights_map_ref_cross"] = np.asarray(
            o2["attn_weights_map_ref_cross"]
        )[:, :gh, :gw, :, :gh, :gw]
    return b2, o2


def iter_bucketed_items(batch: dict, outputs: dict):
    """Split a bucket-PACKED batch (per-item ``_valid_hw`` of shape (B, 2),
    data/bucketing.py) into individually cropped B=1 slices for the host-side
    consumers, none of which can hold a batch of mixed image sizes as one
    array. Yields (i, item_batch, item_outputs) for the valid items (not the
    padding duplicates)."""
    n_valid = int(batch.get("_valid", len(batch["item_paths"]["query/img"])))
    vhw = np.asarray(batch["_valid_hw"])

    def slice_item(tree, i):
        if isinstance(tree, dict):
            return {k: slice_item(v, i) for k, v in tree.items()}
        if isinstance(tree, list):
            # the (K, B) reference path lists slice per view; the JAX package
            # takes view i here instead (an IndexError once i >= K)
            return [[v[i]] for v in tree] if tree and isinstance(tree[0], list) else [tree[i]]
        arr = np.asarray(tree)
        if arr.ndim == 0:
            return tree
        return arr[i:i + 1]

    for i in range(n_valid):
        b1 = {k: slice_item(v, i) for k, v in batch.items() if k not in ("_valid", "_valid_hw")}
        b1["_valid"] = np.asarray(1, np.int32)
        b1["_valid_hw"] = vhw[i]
        o1 = {k: np.asarray(v)[i:i + 1] for k, v in outputs.items()}
        yield i, *crop_bucketed(b1, o1)


def write_batch_outputs(batch_idx: int, batch: dict, outputs: dict, *, summariser, writer, visualiser,
                        vis_dir: Path, vis_every: int, node: int = 0, row_offset: int = 0,
                        write_paths: bool = True) -> None:
    """Hand one batch's host outputs to the per-frame summariser, the batch
    writer (or None) and, every ``vis_every`` batches, a figure
    ``vis_dir/r<node>_B<batch>_b0.png`` (matplotlib); the test and predict
    CLIs' consumers. A bucket-packed batch (per-item ``_valid_hw``) goes to
    them as individually cropped B=1 slices, since none can hold a batch of
    mixed image sizes as one array.

    Over data ranks the batch is this rank's rows of node ``node``'s batch,
    which begin at row ``row_offset``: the files are named as the one rank's
    (``r<node>_B<batch>_b<offset + i>``), the figure is drawn by the rank
    that holds row 0, and ``write_paths=False`` leaves the batch's
    item-path JSON to :func:`write_node_item_paths`."""
    vis = vis_every > 0 and batch_idx % vis_every == 0 and row_offset == 0

    def save_vis(b: dict, o: dict) -> None:
        import matplotlib.pyplot as plt

        fig = visualiser.vis(b, o)
        fig.savefig(Path(vis_dir) / f"r{node}_B{batch_idx:04}_b0.png")
        plt.close(fig)

    vhw = batch.get("_valid_hw")
    if vhw is not None and np.ndim(vhw) == 2:
        for i, b1, o1 in iter_bucketed_items(batch, outputs):
            summariser.update(batch_input=b1, batch_output=o1)
            if i == 0 and vis:
                save_vis(b1, o1)
            if writer is not None:
                writer.write_out(b1, o1, local_rank=node, batch_idx=batch_idx, item_offset=row_offset + i,
                                 item_paths=write_paths)
        return
    batch, outputs = crop_bucketed(batch, outputs)
    summariser.update(batch_input=batch, batch_output=outputs)
    if vis:
        save_vis(batch, outputs)
    if writer is not None:
        writer.write_out(batch, outputs, local_rank=node, batch_idx=batch_idx, item_offset=row_offset,
                         item_paths=write_paths)


def write_node_item_paths(writer, ranks: "DataRanks", batch_idx: int, batch: dict) -> None:
    """The item-path JSON of one node batch under data ranks: every rank's
    paths and ``_valid`` gathered over the data group (a collective: every
    rank calls it), and written by the node's first data rank as the one rank
    writes it, ``r<node>_B<batch>.json`` (a bucket-packed batch holds its
    last valid item, as the one rank's per-item writes leave it)."""
    mine = (ranks.node, dict(batch["item_paths"]), int(batch["_valid"]))
    every = [None] * ranks.data_world
    dist.all_gather_object(every, mine, group=ranks.group)
    if ranks.node_data_rank != 0 or writer is None or not writer.write_flag["item_path_json"]:
        return
    parts = [(paths, n) for node, paths, n in every if node == ranks.node]
    merged = {key: [] for key in ("query/img", "query/score_map")}
    k = len(parts[0][0].get("reference/cross/imgs", []))
    merged["reference/cross/imgs"] = [[] for _ in range(k)]
    for paths, _ in parts:  # each rank's rows, padding included: the node batch in row order
        for key in ("query/img", "query/score_map"):
            merged[key].extend(paths[key])
        for kk in range(k):
            merged["reference/cross/imgs"][kk].extend(paths["reference/cross/imgs"][kk])
    n_valid = sum(n for _, n in parts)
    if np.ndim(batch.get("_valid_hw")) == 2:
        last = n_valid - 1
        merged = {"query/img": merged["query/img"][last:last + 1],
                  "query/score_map": merged["query/score_map"][last:last + 1],
                  "reference/cross/imgs": [v[last:last + 1] for v in merged["reference/cross/imgs"]]}
        n_valid = 1
    writer._write_item_paths({"item_paths": merged}, ranks.node, batch_idx, n_valid)


def gather_summary(summariser, group, main: bool) -> bool:
    """Collect the per-frame summary rows of every rank of ``group`` on the
    main rank (a collective; a rank without a summariser contributes none)
    -> whether this rank holds them all and writes the summary."""
    if group is None or dist.get_world_size(group) == 1:
        return summariser is not None
    import pandas as pd

    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, None if summariser is None else summariser.rows, group=group)
    if not main:
        return False
    frames = [f for f in every if f is not None and not f.empty]
    if frames:
        summariser.rows = pd.concat(frames)
    return True


def refuse_tensor_parallel(attention_impl: str) -> None:
    """The CLIs build no model group, as the JAX CLIs build no model axis
    (``tasks/train.py:202`` there): the ``tp`` route is an API of
    ``parallel.mesh.make_groups`` and ``train.step.make_train_step``."""
    if attention_impl == "tp":
        raise NotImplementedError("model.gpu.attention_impl=tp: the task CLIs build no model group, as "
                                  "the JAX CLIs build no model axis; use parallel.mesh.make_groups and "
                                  "train.step.make_train_step")


def refuse_multi_rank(cfg: Config) -> None:
    """The scoring daemon runs one process over its local devices, as the JAX
    daemon does; a router over replicas is a feature the JAX package lacks.
    A launch of several ranks (``WORLD_SIZE`` > 1), or a ``trainer.devices``
    other than 1 or -1, raises rather than running independent copies
    behind one port."""
    devices = cfg.trainer.get("devices", -1)
    n_dev = devices if isinstance(devices, int) else len(devices) if devices is not None else -1
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if n_dev not in (1, -1) or world > 1:
        raise NotImplementedError(
            f"trainer.devices={devices!r} with WORLD_SIZE={world}: the serve daemon runs one process over "
            "its local devices (the constructor's devices=, model.gpu.serve_data_parallel), as the JAX "
            "daemon does; run one process, and one daemon per card behind a router of your own"
        )


@dataclasses.dataclass(frozen=True)
class DataRanks:
    """This rank's place in the CLIs' data layout (:func:`data_ranks`): one
    node of the port for one JAX process, the node's first ``node_width``
    ranks taking contiguous blocks of each node batch."""

    top: mesh.Topology
    device: torch.device
    group: Optional[dist.ProcessGroup]  # the data group; None on one rank or outside the grid
    data_world: int                     # the data ranks over every node
    node_width: int                     # the data ranks of each node
    node_data_rank: Optional[int]       # this rank's block in its node's batches; None outside the grid

    @property
    def active(self) -> bool:
        return self.node_data_rank is not None

    @property
    def is_main(self) -> bool:
        return self.top.rank == 0

    @property
    def node(self) -> int:
        return self.top.rank // self.top.local_world_size

    @property
    def tag(self) -> str:
        return f"[rank {self.top.rank}/{self.top.world_size}] " if self.top.world_size > 1 else ""

    def loader_kw(self) -> dict:
        """The loader's node shard and this rank's block of each node batch."""
        return dict(shard_index=self.node, num_shards=self.top.n_nodes,
                    rank_index=self.node_data_rank or 0, rank_count=self.node_width)

    def row_offset(self, batch_size: int) -> int:
        """The node-batch row where this rank's block begins."""
        return (self.node_data_rank or 0) * (batch_size // self.node_width)

    def broadcast(self, obj):
        """Rank 0's ``obj`` on every rank of the data group."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def layout_data(top: mesh.Topology, device: torch.device, batch_size: int, n_ranks: int, cli: str) -> DataRanks:
    """Lay the joined ranks out for data parallelism
    (``parallel.mesh.make_groups(1, batch_size)`` over the first ``n_ranks``,
    every node keeping the same ranks) -> this rank's :class:`DataRanks`. A
    rank past the grid says so on stdout."""
    grid = mesh.make_groups(1, batch_size, n_ranks=n_ranks)
    width = grid.data_parallel // top.n_nodes  # every node keeps the same ranks
    ranks = DataRanks(top, device, mesh.data_group() if grid.active else None, grid.data_parallel, width,
                      None if not grid.active else grid.data_rank % width)
    if not grid.active:
        print(f"{ranks.tag}{cli}: this rank is outside the data layout ({grid.data_parallel} data ranks over "
              f"{top.n_nodes} node(s), batch {batch_size} a node); it waits for the others", flush=True)
    return ranks


@contextlib.contextmanager
def joined_ranks(cfg: Config):
    """Join the launcher's process group when there are several ranks ->
    yields (topology, this rank's device). One rank per card, launched by
    ``torchrun`` (``--nnodes`` with the rendezvous flags for several nodes)
    or ``parallel.launch``; ``model.gpu.dist_backend``: ``nccl`` for one
    rank per card, ``gloo`` on the CPU and for ranks that share a card. The
    kernels are built once per node. A rank that cannot join raises; on the
    way out every rank waits for the others, then leaves the group.
    ``trainer.devices`` above the launched ranks raises before anything."""
    top = mesh.topology_from_env()
    mesh.requested_ranks(cfg.trainer.get("devices", -1), top.world_size)
    if top.world_size == 1:
        yield top, resolve_accelerator(cfg)
        return
    _, device = mesh.init_distributed(str(cfg.model.gpu.get("dist_backend", "nccl")),
                                      str(cfg.trainer.get("accelerator", "cuda")))
    try:
        if device.type == "cuda":  # one build for the node's ranks
            if top.local_rank == 0:
                from crossscore_tpu_torch.ops import _build

                _build.build_all()
            dist.barrier()
        yield top, device
        dist.barrier()
    finally:
        mesh.teardown()


@contextlib.contextmanager
def data_ranks(cfg: Config, batch_size: int, cli: str):
    """The train and test CLIs' ranks (:func:`joined_ranks`), laid out as the
    JAX ``make_mesh(n_devices, batch_size=...)`` lays out devices over
    processes (:func:`layout_data`): ``trainer.devices`` counts ranks (-1:
    every launched rank), the data width of each node divides its
    ``batch_size``, and a rank past the grid only waits for the others.
    Yields this rank's :class:`DataRanks`."""
    with joined_ranks(cfg) as (top, device):
        if top.world_size == 1:
            yield DataRanks(top, device, None, 1, 1, 0)
        else:
            yield layout_data(top, device, batch_size, mesh.requested_ranks(cfg.trainer.get("devices", -1),
                                                                       top.world_size), cli)


def resolve_accelerator(cfg: Config) -> torch.device:
    """``trainer.accelerator``: ``cuda`` (the default; raises without a card)
    or ``cpu`` (the plain PyTorch versions of every kernel). Nothing else, and
    no fallback from one to the other."""
    accel = str(cfg.trainer.get("accelerator", "cuda"))
    if accel not in ("cuda", "cpu"):
        raise ValueError(f"trainer.accelerator must be cuda or cpu, got {accel!r}")
    return resolve_device(None if accel == "cuda" else "cpu")


def save_config_snapshot(cfg: Config, out_dir: Path) -> Path:
    """Persist the composed config into the run dir (hydra's
    ``.hydra/config.yaml``, reference ``config/default.yaml:6-8``)."""
    path = Path(out_dir) / "config.yaml"
    path.write_text(yaml.safe_dump(cfg.to_dict(), sort_keys=False))
    return path


def config_diff(old, new, prefix: str = "") -> list[str]:
    """Recursive leaf-level diff of two nested config dicts, as
    ``key.path: old -> new`` lines (the resume mismatch warning)."""
    lines: list[str] = []
    keys = sorted(set(old) | set(new)) if isinstance(old, dict) and isinstance(new, dict) else None
    if keys is None:
        if old != new:
            lines.append(f"{prefix}: {old!r} -> {new!r}")
        return lines
    for k in keys:
        p = f"{prefix}.{k}" if prefix else str(k)
        if k not in old:
            lines.append(f"{p}: <absent> -> {new[k]!r}")
        elif k not in new:
            lines.append(f"{p}: {old[k]!r} -> <absent>")
        else:
            lines.extend(config_diff(old[k], new[k], p))
    return lines


def weighted_mean(series: list, weights: list) -> list[float]:
    """Weighted means of one or more metric series (the reference's epoch
    reduction of ``self.log``, ``task/core.py:449``, for one process)."""
    return all_process_weighted_mean(series, weights)


def all_process_weighted_mean(series: list, weights: list, group=None, device="cpu") -> list[float]:
    """Weighted means of one or more metric series over the ranks of
    ``group`` (the reference's ``self.log(..., sync_dist=True)``): each rank
    contributes float64 (sum(w*x), sum(w)), summed over the group, so the
    mean covers every rank's data; the port's counterpart of the JAX
    ``all_process_weighted_mean``. With no group, or one rank, the local
    weighted mean. A collective: every rank of the group must call it.
    ``device``: where the sums meet (a CUDA device under nccl)."""
    w = np.asarray(weights, np.float64)
    sums = [float(np.sum(w * np.asarray(s, np.float64))) for s in series] + [float(w.sum())]
    if group is not None and dist.get_world_size(group) > 1:
        t = all_reduce(torch.tensor(sums, dtype=torch.float64, device=device), dist.ReduceOp.SUM, group)
        sums = t.cpu().tolist()
    denom = max(sums[-1], 1e-12)
    return [x / denom for x in sums[:-1]]


class JsonlLogger:
    """Metric logging to ``<run_dir>/metrics.jsonl``, and to wandb with
    ``use_wandb`` where it is installed (else a message, and the file only),
    as the JAX ``JsonlLogger``."""

    def __init__(self, run_dir: Path, cfg=None, use_wandb: bool = False):
        self.path = Path(run_dir) / "metrics.jsonl"
        self.f = open(self.path, "a")
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb.init(project=cfg.project.name, dir=str(run_dir))
            except Exception as e:  # offline, or not installed: the file only
                print(f"wandb unavailable ({e}); logging to {self.path} only")

    def log(self, metrics: dict, step: int):
        row = {"step": step, "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        self.f.write(json.dumps(row) + "\n")
        self.f.flush()
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def log_histogram(self, name: str, values, step: int):
        """The 10-bin counts of ``values`` as ``{name}_{i}`` rows (and a
        ``wandb.Histogram``): the reference logs histograms of the scores and
        the L1 differences (``task/core.py:351-362``)."""
        counts, edges = np.histogram(np.asarray(values).reshape(-1), bins=10)
        self.log({f"{name}_{i}": float(c) for i, c in enumerate(counts)}, step)
        if self.wandb is not None:
            import wandb

            self.wandb.log({name: wandb.Histogram(np_histogram=(counts, edges))}, step=step)

    def log_figure(self, name: str, fig, step: int):
        """A matplotlib figure as a ``wandb.Image``; without wandb nothing
        (the caller writes every figure to disk)."""
        if self.wandb is not None:
            import wandb

            self.wandb.log({name: wandb.Image(fig)}, step=step)

    def close(self):
        self.f.close()
        if self.wandb is not None:
            self.wandb.finish()
