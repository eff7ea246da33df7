"""Predict entry point: score maps from bare query/reference dirs, on one CUDA
card; the port's counterpart of ``crossscore_tpu/tasks/predict.py``.

    python -m crossscore_tpu_torch.tasks.predict \\
        trainer.ckpt_path_to_load=<lightning .ckpt | train run's ckpt/ dir> \\
        data.dataset.query_dir=<dir> data.dataset.reference_dir=<dir> alias=<name>

Outputs (the reference's layout): ``<out_dir>/vis/r0_B****_b0.png`` figures,
``<out_dir>/batch/score_map_ref_cross/*.png`` score maps, ``image_query/``,
``image_reference/``, ``score_summary/<dataset>/<method>.csv``.

Two modes decide which kernels run (``plan_serving_modes``):

- the reference-token cache (``this_main.ref_token_cache``, on under
  ``auto`` unless attention weights are asked for): each reference image goes
  through the frozen backbone once per run (``data/token_cache.py``) and the
  step encodes the queries alone;
- shape buckets (``this_main.shape_buckets``, on under ``auto`` when the
  items have more than one shape): items are padded to multiples of
  ``bucket_multiple`` and the padded tokens masked, through K5 in every
  backbone block and K6 in every decoder attention.

With the cache on, no buckets, no figures, no reference copies written and
the whole reference pool within ``ref_token_cache_max_items``, the native
decoder (``data/fastimage.py``) skips the decode of every reference the
cache holds (the start line says ``decode-skip on``; the last cache line
counts the skips). ``+data.dataset.record_dir=<dir>`` reads the images
from record shards (``python -m crossscore_tpu_torch.data.pack <root> <dir>
[--decoded]``, where ``<root>`` is the deepest directory that holds both the
query and the reference directory); the JAX CLI has no such key.

One process per card: ``trainer.accelerator=cuda`` (the default) or ``cpu``
(the plain PyTorch versions of every kernel). Several ranks (``torchrun
--nproc_per_node N -m crossscore_tpu_torch.tasks.predict ...``, ``--nnodes``
with the rendezvous flags for several nodes, or ``parallel.launch``;
``model.gpu.dist_backend``: ``nccl``, or ``gloo`` on the CPU and for ranks
that share a card) take the JAX package's plan (``plan_serving_modes``), one
node standing for one JAX process:

- data parallel (the default): each node takes its shard of the queries,
  its ranks contiguous blocks of each node batch, and each rank writes its
  own rows under the node's index and its row offset, so that one node's
  files are those of one rank (``r<node>_B<batch>_b<row>``);
- view parallel (``model.gpu.view_parallel=on``, or ``auto`` when the batch
  cannot fill the ranks; K divisible by the ranks): each rank loads every
  batch, encodes the queries and its K/N reference views (or keeps a token
  cache of those views alone), and the decoder combines the views exactly
  over the ranks; rank 0 alone writes;
- over several nodes with the cache on, view parallel within each node
  (``vp_local``): each node takes its shard of the queries, and its first
  rank writes them under the node's index.

Rank 0 writes the per-frame summary of every rank's rows.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from crossscore_tpu_torch.data.simple_reference import SimpleReference
from crossscore_tpu_torch.io.batch_writer import BatchWriter
from crossscore_tpu_torch.io.summariser import SummaryWriterPredictedOnlineTestPrediction
from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
from crossscore_tpu_torch.parallel import mesh
from crossscore_tpu_torch.parallel.mesh import Topology, _per_process_data_par
from crossscore_tpu_torch.parallel.view_parallel import (
    make_view_parallel_apply, make_view_parallel_apply_tokens, view_shard,
)
from crossscore_tpu_torch.tasks.common import (
    confirm_batch_size, eval_loader, gather_summary, joined_ranks, layout_data, load_model_params, parse_cli,
    ref_token_cache, refuse_tensor_parallel, resolve_limit, resolve_out_dir, set_decode_skip, tristate,
    use_shape_buckets, write_batch_outputs, write_node_item_paths,
)
from crossscore_tpu_torch.train.step import make_predict_step, make_predict_step_cached
from crossscore_tpu_torch.utils.check_config import ConfigChecker
from crossscore_tpu_torch.utils.vis import make_visualiser


class ServingPlan(NamedTuple):
    """The serving composition (the port's copy of the JAX ``ServingPlan``)."""

    use_vp: bool      # K reference views sharded over the ranks
    vp_local: bool    # ... over one node's ranks of a multi-node run
    use_cache: bool   # reference-token cache on


def plan_serving_modes(
    *,
    vp_mode: str,
    cache_mode: str,
    use_buckets: bool,
    need_attn_weights: bool,
    zero_reference: bool,
    k_refs: int,
    n_dev: int,
    n_local: int,
    n_proc: int,
    data_mesh_size: int,
) -> ServingPlan:
    """The JAX package's plan, with one rank per card: ``n_dev`` ranks in all,
    ``n_local`` on each of ``n_proc`` nodes, and a data-parallel width of
    ``data_mesh_size``. The views are sharded when asked (``on``), or under
    ``auto`` when the batch cannot fill the ranks, with K divisible by the
    ranks, no buckets and no attention weights; over several nodes with the
    cache on, within each node (``vp_local``). Otherwise several ranks run
    data parallel."""
    cache_ok = cache_mode != "off" and not need_attn_weights and k_refs > 0 and not zero_reference

    def vp_fits(n: int) -> bool:
        return (not use_buckets and vp_mode != "off" and not need_attn_weights and n > 1
                and k_refs > 0 and k_refs % n == 0 and (vp_mode == "on" or data_mesh_size < n))

    vp_local = n_proc > 1 and cache_ok and vp_fits(n_local)
    use_vp = vp_local or vp_fits(n_dev)
    use_cache = cache_ok and not (n_proc > 1 and use_vp and not vp_local)
    return ServingPlan(use_vp, vp_local, use_cache)


def predict(cfg) -> Path:
    """Run the CLI on this rank; joins (and leaves) the launcher's process
    group when there are several ranks. Returns the output dir, the same on
    every rank."""
    ConfigChecker(cfg).check_predict()
    refuse_tensor_parallel(str(cfg.model.gpu.attention_impl))
    with joined_ranks(cfg) as (top, device):
        return _predict(cfg, top, device)


def _predict(cfg, top: Topology, device: torch.device) -> Path:
    ranks = top.world_size
    tag = f"[rank {top.rank}/{ranks}] " if ranks > 1 else ""
    if device.type == "cuda":
        # full fp32 for fp32 products and convolutions (cuDNN defaults to TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    confirm_batch_size(cfg)
    out_dir = None
    if top.rank == 0:  # rank 0 alone writes
        out_dir = resolve_out_dir(cfg, "predict")
        (out_dir / "vis").mkdir(parents=True, exist_ok=True)
    if ranks > 1:
        box = [None if out_dir is None else str(out_dir)]
        dist.broadcast_object_list(box, src=0)
        out_dir = Path(box[0])
        cfg.logger.predict.out_dir = str(out_dir)

    dataset = SimpleReference(
        query_dir=cfg.data.dataset.query_dir,
        reference_dir=cfg.data.dataset.reference_dir,
        neighbour_config=cfg.data.neighbour_config,
        crop_size=cfg.data.transforms.crop_size,
        crop_mode=cfg.this_main.crop_mode,
        resize_short_side=cfg.this_main.resize_short_side,
        zero_reference=cfg.data.dataset.zero_reference,
        return_item_paths=True,
        wire_uint8=bool(cfg.data.dataset.get("wire_uint8", False)),
        record_dir=cfg.data.dataset.get("record_dir"),
    )
    use_buckets, _ = use_shape_buckets(cfg, dataset)
    k_refs = int(cfg.data.neighbour_config.cross)
    batch_size = int(cfg.data.loader.validation.batch_size)
    plan = plan_serving_modes(
        vp_mode=tristate(cfg.model.gpu.get("view_parallel", "auto")),
        cache_mode=tristate(cfg.this_main.get("ref_token_cache", "auto")),
        use_buckets=use_buckets,
        need_attn_weights=cfg.model.need_attn_weights,
        zero_reference=cfg.data.dataset.zero_reference,
        k_refs=k_refs,
        n_dev=ranks,
        n_local=top.local_world_size,
        n_proc=top.n_nodes,
        data_mesh_size=top.n_nodes * _per_process_data_par(top.local_world_size, 1, batch_size),
    )
    use_vp, use_cache = plan.use_vp, plan.use_cache

    # who loads what and who writes: data parallel, each rank its rows of its
    # node's shard; view parallel over every rank, every batch on every rank
    # and rank 0 writing; view parallel within nodes (vp_local), each node its
    # shard and its first rank writing
    data = None
    node = top.rank // top.local_world_size
    if ranks > 1 and plan.vp_local:
        groups = [dist.new_group(list(range(n * top.local_world_size, (n + 1) * top.local_world_size)))
                  for n in range(top.n_nodes)]
        mesh.set_view_group(groups[node])
        split, writes, gather_group = (dict(shard_index=node, num_shards=top.n_nodes), top.local_rank == 0,
                                       dist.group.WORLD)
    elif ranks > 1 and not use_vp:
        data = layout_data(top, device, batch_size, mesh.requested_ranks(cfg.trainer.get("devices", -1), ranks),
                           "predict")
        if not data.active:
            return out_dir
        split, writes, gather_group = data.loader_kw(), True, data.group
    else:
        split, writes, gather_group, node = None, top.rank == 0, None, 0
    multi_writer = data is not None and data.data_world > 1
    row_offset = data.row_offset(batch_size) if data is not None else 0
    loader, _ = eval_loader(cfg, dataset, "predict", split)

    mcfg = CrossScoreConfig.from_config(cfg)
    if use_vp:
        mcfg = dataclasses.replace(mcfg, attention_impl="cp")
        n_vp = dist.get_world_size(mesh.view_group())
        shard = view_shard(k_refs)
        print(f"{tag}view-parallel predict: K={k_refs} references over {n_vp} ranks; this rank "
              f"takes views [{shard.start}, {shard.stop})")
    elif data is not None and data.data_world > 1:
        b = batch_size // data.node_width
        print(f"{tag}data-parallel predict: {data.data_world} data ranks over {top.n_nodes} node(s); this rank "
              f"takes rows [{row_offset}, {row_offset + b}) of node {node}'s batches of {batch_size}")
    model = load_model_params(cfg, CrossScoreNet(mcfg, device=device))

    writer = summariser = visualiser = None
    if writes:
        writer = BatchWriter(cfg, "predict") if cfg.logger.predict.write.flag.batch else None
        summariser = SummaryWriterPredictedOnlineTestPrediction(
            metric_type=cfg.model.predict.metric.type,
            metric_min=cfg.model.predict.metric.min,
            dir_out=str(out_dir),
        )
        visualiser = make_visualiser(cfg)
    vis_every = cfg.logger.predict.write.config.vis_img_every_n_steps

    def to_device(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, non_blocking=True)

    h2d_bytes = 0
    if use_cache:
        encoder = make_backbone_encoder(mcfg)
        # under view parallelism each rank caches the tokens of its own views
        token_cache = ref_token_cache(
            cfg, lambda imgs, valid_hw=None: encoder(model, to_device(imgs), valid_hw))
        step_cached = make_view_parallel_apply_tokens(model) if use_vp else make_predict_step_cached(model)
        # skip the host decode of the references the cache holds (the loader
        # emits placeholders) when nothing downstream reads reference pixels
        # and the whole pool fits the cache, so that nothing is evicted.
        # Bucketed batches keep decoding: their keys carry the bucket shape,
        # which the loader's header probe does not know
        use_skip = (vis_every <= 0 and not use_buckets and not cfg.logger.predict.write.flag.image_reference
                    and dataset.reference_pool_size() <= int(cfg.this_main.get("ref_token_cache_max_items", 2048))
                    and set_decode_skip(dataset, token_cache, query=False))
        print(f"{tag}reference-token cache: on (frozen backbone; decode-skip {'on' if use_skip else 'off'}"
              f"{'; bucketed' if use_buckets else ''}{'; view-parallel' if use_vp else ''})")

        def step(batch: dict) -> dict:
            nonlocal h2d_bytes
            vhw = batch.get("_valid_hw")
            paths, refs = batch["item_paths"]["reference/cross/imgs"], batch["reference/cross/imgs"]
            skipped = batch.get("reference/skipped")
            if use_vp:
                paths, refs = paths[shard], refs[:, shard]
                skipped = None if skipped is None else skipped[:, shard]
            tokens = token_cache.gather(paths, refs, skipped=skipped, valid_hw=vhw)
            h2d_bytes += batch["query/img"].nbytes + tokens.numel() * tokens.element_size()
            query, tokens = to_device(batch["query/img"]), tokens.to(device, non_blocking=True)
            if use_vp:
                return {"score_map_ref_cross": step_cached(query, tokens)}
            return step_cached(query, tokens, vhw)
    else:
        if use_vp:
            step_vp = make_view_parallel_apply(model)
        else:
            step_plain = make_predict_step(model, need_attn_weights=cfg.model.need_attn_weights,
                                           head_id=cfg.model.need_attn_weights_head_id)

        def step(batch: dict) -> dict:
            nonlocal h2d_bytes
            refs = batch.get("reference/cross/imgs")
            if use_vp:
                refs = refs[:, shard]
            h2d_bytes += batch["query/img"].nbytes + (0 if refs is None else refs.nbytes)
            query, refs = to_device(batch["query/img"]), None if refs is None else to_device(refs)
            if use_vp:
                return {"score_map_ref_cross": step_vp(query, refs)}
            return step_plain(query, refs, batch.get("_valid_hw"))

    max_batches = resolve_limit(cfg.trainer.limit_test_batches, loader.batches_per_epoch())
    digest = hashlib.sha256()

    def process(batch_idx: int, batch: dict, outputs_dev: dict) -> None:
        # the device copy waits for the step; everything after is host-side
        outputs = {k: v.float().cpu().numpy() for k, v in outputs_dev.items()}
        digest.update(outputs["score_map_ref_cross"].tobytes())
        if writes:  # under view parallelism the other ranks computed the same maps
            write_batch_outputs(batch_idx, batch, outputs, summariser=summariser, writer=writer,
                                visualiser=visualiser, vis_dir=out_dir / "vis", vis_every=vis_every,
                                node=node, row_offset=row_offset, write_paths=not multi_writer)
        if multi_writer and writer is not None:
            write_node_item_paths(writer, data, batch_idx, batch)

    # one-deep pipeline: dispatch batch i+1 before materialising batch i's
    # outputs, overlapping device work with host-side writing. Under view
    # parallelism every rank steps through every batch, the partial last one
    # included: each decoder layer is a collective.
    n_batches = n_maps = 0
    pending = None
    t0 = time.perf_counter()
    for batch_idx, batch in enumerate(loader.epoch(0)):
        if max_batches is not None and batch_idx >= max_batches:
            break
        outputs_dev = step(batch)
        if pending is not None:
            process(*pending)
        pending = (batch_idx, batch, outputs_dev)
        n_batches += 1
        n_maps += int(batch["_valid"])
    if pending is not None:
        process(*pending)
    seconds = time.perf_counter() - t0

    if gather_summary(summariser, gather_group, top.rank == 0):
        summariser.summarise()
    if use_cache:
        print(f"{tag}ref-token cache: {token_cache.hits} hits, {token_cache.misses} unique misses, "
              f"{token_cache.skipped_decodes} decode-skips")
    per_batch = h2d_bytes / max(n_batches, 1) / 2**20
    shared = f" ({ranks} ranks in step)" if ranks > 1 else ""
    print(f"{tag}predict: {n_maps} maps in {seconds:.3f} s = {n_maps / max(seconds, 1e-9):.2f} maps/s "
          f"(loader, device and writers in the loop{shared}); host-to-device {per_batch:.2f} MiB per batch")
    if ranks > 1:
        print(f"{tag}predict: score maps sha256 {digest.hexdigest()}")
    print(f"{tag}predict done: {n_batches} batches -> {out_dir}")
    return out_dir


def main(argv=None):
    return predict(parse_cli("default_predict", argv))


if __name__ == "__main__":
    main()
