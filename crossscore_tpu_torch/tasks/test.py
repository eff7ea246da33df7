"""Test/eval entry point: metrics against the GT score maps of an NVS tree, on
one CUDA card; the port's counterpart of ``crossscore_tpu/tasks/test.py``.

    python -m crossscore_tpu_torch.tasks.test \\
        trainer.ckpt_path_to_load=<lightning .ckpt | train run's ckpt/ dir> \\
        'data.dataset.path=[<root>]' this_main.data_split=test

Computes the L1 loss, PSNR-from-L1 and the Pearson correlation per batch, and
writes (the reference's layout) ``<out_dir>/metrics.csv`` (one row per batch,
then a ``mean`` row weighted by each batch's valid item count),
``score_summary/<dataset>/<method>.csv`` per-frame summaries, gray uint16
score maps and item-path JSONs under ``batch/``, and ``vis/`` figures. Images
are cropped to whole patches (``crop_mode=integer_patches``), so any size
evaluates without resampling the GT maps.

Two modes decide which kernels run, as in the predict CLI:

- shape buckets (``this_main.shape_buckets``, on under ``auto`` when the
  items have more than one shape): items are padded to multiples of
  ``bucket_multiple``, the padded tokens masked through K5 in every backbone
  block and K6 in every decoder attention, and the padded pixels weighed out
  of every metric (``train/step.py::_weights``);
- the reference-token cache (``this_main.ref_token_cache``, on under
  ``auto`` unless the references are zero): each reference image goes
  through the frozen backbone once per run (exact: test crops are
  deterministic per path), keyed by its valid extent under buckets.

One rank per card: ``trainer.accelerator=cuda`` (the default) or ``cpu``
(the plain PyTorch versions of every kernel). Several ranks (``torchrun
--nproc_per_node N -m crossscore_tpu_torch.tasks.test ...``, ``--nnodes``
for several nodes) evaluate data parallel as the train CLI trains, one node
for one JAX process: each node takes its shard of the items, its ranks
contiguous blocks of each node batch. The metrics of each batch are the
global batch's; rank 0 writes ``metrics.csv`` (a row per global batch, the
mean summed over the ranks) and the per-frame summary, and each rank writes
its own rows' maps and images under the node's index and its row offset, so
that the files are those of one rank (``r<node>_B<batch>_b<row>``). Each
rank keeps its own token cache, over the shared disk store when there is one.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path

import torch

from crossscore_tpu_torch.data.nvs_index import get_dataset
from crossscore_tpu_torch.io.batch_writer import BatchWriter
from crossscore_tpu_torch.io.summariser import SummaryWriterPredictedOnlineTestPrediction
from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
from crossscore_tpu_torch.tasks.common import (
    DataRanks, all_process_weighted_mean, confirm_batch_size, data_ranks, eval_loader, gather_summary,
    load_model_params, parse_cli, ref_token_cache, refuse_tensor_parallel, resolve_limit, resolve_out_dir,
    tristate, write_batch_outputs, write_node_item_paths,
)
from crossscore_tpu_torch.train.step import batch_to_device, make_eval_step
from crossscore_tpu_torch.utils.check_config import ConfigChecker
from crossscore_tpu_torch.utils.vis import make_visualiser


def test(cfg) -> Path | None:
    """Run the CLI on this rank; joins (and leaves) the launcher's process
    group when there are several ranks. Returns the output dir, the same on
    every rank of the data layout (None on a rank outside it)."""
    ConfigChecker(cfg).check_test()
    refuse_tensor_parallel(str(cfg.model.gpu.attention_impl))
    with data_ranks(cfg, int(cfg.data.loader.validation.batch_size), "test") as ranks:
        if not ranks.active:
            return None
        return _test(cfg, ranks)


def _test(cfg, ranks: DataRanks) -> Path:
    device = ranks.device
    if device.type == "cuda":
        # full fp32 for fp32 products and convolutions (cuDNN defaults to TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    confirm_batch_size(cfg)
    out_dir = None
    if ranks.is_main:  # rank 0 makes the output dir; every rank writes into it
        out_dir = resolve_out_dir(cfg, "test")
        (out_dir / "vis").mkdir(parents=True, exist_ok=True)
    out_dir = Path(ranks.broadcast(None if out_dir is None else str(out_dir)))
    cfg.logger.test.out_dir = str(out_dir)

    dataset = get_dataset(cfg, cfg.this_main.data_split, return_item_paths=True,
                          crop_mode=cfg.this_main.crop_mode, resize_short_side=cfg.this_main.resize_short_side,
                          deterministic_crop=True)
    loader, use_buckets = eval_loader(cfg, dataset, "test", ranks.loader_kw())
    multi = ranks.data_world > 1
    row_offset = ranks.row_offset(int(cfg.data.loader.validation.batch_size))
    use_cache = (tristate(cfg.this_main.get("ref_token_cache", "auto")) != "off"
                 and int(cfg.data.neighbour_config.cross) > 0 and not cfg.data.dataset.zero_reference)

    mcfg = CrossScoreConfig.from_config(cfg)
    model = load_model_params(cfg, CrossScoreNet(mcfg, device=device))
    writer = BatchWriter(cfg, "test") if cfg.logger.test.write.flag.batch else None
    summariser = SummaryWriterPredictedOnlineTestPrediction(
        metric_type=cfg.model.predict.metric.type,
        metric_min=cfg.model.predict.metric.min,
        dir_out=str(out_dir),
    )
    visualiser = make_visualiser(cfg)
    vis_every = cfg.logger.test.write.config.vis_img_every_n_steps
    eval_step = make_eval_step(model)

    token_cache = None
    if use_cache:
        encoder = make_backbone_encoder(mcfg)
        token_cache = ref_token_cache(
            cfg, lambda imgs, valid_hw=None: encoder(model, torch.from_numpy(imgs).to(device), valid_hw))
        print(f"{ranks.tag}reference-token cache: on (frozen backbone, exact{'; bucketed' if use_buckets else ''})")

    def step(batch: dict):
        # _valid (and _valid_hw) ride into the step: the metrics weigh out
        # padded duplicate items and bucket padding
        arrays = {k: v for k, v in batch.items() if k != "item_paths"}
        if token_cache is not None:
            arrays["reference/cross/tokens"] = token_cache.gather(
                batch["item_paths"]["reference/cross/imgs"], arrays.pop("reference/cross/imgs"),
                # bucket-padded batches: per-item extents qualify the cache
                # keys and mask the misses' encode
                valid_hw=batch.get("_valid_hw"))
        return eval_step(batch_to_device(arrays, device))

    max_batches = resolve_limit(cfg.trainer.limit_test_batches, loader.batches_per_epoch())
    rows: list[dict] = []
    row_weights: list[int] = []  # valid (non-padded) items per batch

    def process(batch_idx: int, batch: dict, pred_dev: torch.Tensor, metrics_dev: dict) -> None:
        # the device copy waits for the step; everything after is host-side
        outputs = {"score_map_ref_cross": pred_dev.float().cpu().numpy()}
        rows.append({
            "batch_idx": batch_idx,
            "test/loss": float(metrics_dev["loss"]),
            "test/loss_cross": float(metrics_dev["loss_cross"]),
            "test/corr_cross": float(metrics_dev["correlation_cross"]),
            "test/psnr_cross": float(metrics_dev["psnr_cross"]),
        })
        row_weights.append(int(batch.get("_valid", len(batch["query/img"]))))
        # the metrics above are masked per item already; the consumers take
        # bucket-packed batches as cropped B=1 slices. Over ranks each writes
        # its own rows, and the node's item paths are gathered for one JSON
        write_batch_outputs(batch_idx, batch, outputs, summariser=summariser, writer=writer,
                            visualiser=visualiser, vis_dir=out_dir / "vis", vis_every=vis_every,
                            node=ranks.node, row_offset=row_offset, write_paths=not multi)
        if multi and writer is not None:
            write_node_item_paths(writer, ranks, batch_idx, batch)

    # one-deep pipeline: dispatch batch i+1 before materialising batch i's
    # outputs, overlapping device work with host-side writing
    n_maps = 0
    pending = None
    t0 = time.perf_counter()
    for batch_idx, batch in enumerate(loader.epoch(0)):
        if max_batches is not None and batch_idx >= max_batches:
            break
        pred_dev, metrics_dev = step(batch)
        if pending is not None:
            process(*pending)
        pending = (batch_idx, batch, pred_dev, metrics_dev)
        n_maps += int(batch["_valid"])
    if pending is not None:
        process(*pending)
    seconds = time.perf_counter() - t0

    if rows:
        # the CSVLogger's epoch metrics: the mean row weighs each batch by its
        # valid item count, summed over the ranks (sync_dist), so every item
        # counts once. A collective; each row is already the global batch's
        keys = [k for k in rows[0] if k != "batch_idx"]
        agg = dict(zip(keys, all_process_weighted_mean([[r[k] for r in rows] for k in keys], row_weights,
                                                       ranks.group, device)))
    if rows and ranks.is_main:
        with open(out_dir / "metrics.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
            w.writerow({"batch_idx": "mean", **{k: round(v, 6) for k, v in agg.items()}})
        print("test metrics:", agg)
    if gather_summary(summariser, ranks.group, ranks.is_main):
        summariser.summarise()
    if token_cache is not None:
        print(f"{ranks.tag}ref-token cache: {token_cache.hits} hits, {token_cache.misses} unique misses, "
              f"{token_cache.disk_hits} disk hits")
    shared = f" ({ranks.top.world_size} ranks in step)" if multi else ""
    print(f"{ranks.tag}test: {n_maps} maps in {seconds:.3f} s = {n_maps / max(seconds, 1e-9):.2f} maps/s "
          f"(loader, device, metrics and writers in the loop{shared})")
    print(f"{ranks.tag}test done: {len(rows)} batches -> {out_dir}")
    return out_dir


def main(argv=None):
    return test(parse_cli("default_test", argv))


if __name__ == "__main__":
    main()
