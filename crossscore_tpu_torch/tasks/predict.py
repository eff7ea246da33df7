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

One process, one device: ``trainer.accelerator=cuda`` (the default) or
``cpu`` (the plain PyTorch versions of every kernel). View parallelism (the K
references sharded over several cards) is not ported.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from crossscore_tpu_torch.data.bucketing import ShapeBucketedLoader
from crossscore_tpu_torch.data.loader import Loader
from crossscore_tpu_torch.data.simple_reference import SimpleReference
from crossscore_tpu_torch.data.token_cache import RefTokenCache
from crossscore_tpu_torch.io.batch_writer import BatchWriter
from crossscore_tpu_torch.io.summariser import SummaryWriterPredictedOnlineTestPrediction
from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
from crossscore_tpu_torch.tasks.common import (
    confirm_batch_size, crop_bucketed, iter_bucketed_items, load_model_params, parse_cli,
    resolve_accelerator, resolve_limit, resolve_out_dir, tristate,
)
from crossscore_tpu_torch.train.step import make_predict_step, make_predict_step_cached
from crossscore_tpu_torch.utils.check_config import ConfigChecker
from crossscore_tpu_torch.utils.vis import make_visualiser


def plan_serving_modes(
    *,
    vp_mode: str,
    cache_mode: str,
    use_buckets: bool,
    need_attn_weights: bool,
    zero_reference: bool,
    k_refs: int,
    n_dev: int,
) -> bool:
    """Whether the reference-token cache is on, by the JAX package's rule for
    one process whose data-parallel mesh spans its ``n_dev`` devices.

    That rule shards the K reference views over the devices (view
    parallelism) only when asked (``vp_mode == "on"``), with K divisible by
    ``n_dev`` > 1, no buckets and no attention weights. The port has no view
    parallelism, so that plan raises ``NotImplementedError``."""
    if (vp_mode == "on" and not use_buckets and not need_attn_weights
            and n_dev > 1 and k_refs > 0 and k_refs % n_dev == 0):
        raise NotImplementedError(
            f"view-parallel predict (K={k_refs} references over {n_dev} devices) is not ported: "
            "ROADMAP queue 1 item 13; set model.gpu.view_parallel=off"
        )
    return cache_mode != "off" and not need_attn_weights and k_refs > 0 and not zero_reference


def predict(cfg) -> Path:
    ConfigChecker(cfg).check_predict()
    device = resolve_accelerator(cfg)
    if device.type == "cuda":
        # full fp32 for fp32 products and convolutions (cuDNN defaults to TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    confirm_batch_size(cfg)
    out_dir = resolve_out_dir(cfg, "predict")
    (out_dir / "vis").mkdir(parents=True, exist_ok=True)

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
    )
    bucket_mode = tristate(cfg.this_main.get("shape_buckets", "auto"))
    use_buckets = bucket_mode != "off" and cfg.this_main.crop_mode != "dataset_default"
    if use_buckets:
        shapes = {dataset.get_item_shape(i) for i in range(len(dataset))}
        if bucket_mode == "auto" and len(shapes) <= 1:
            use_buckets = False  # one shape: padding buys nothing

    # one process: view parallelism is selectable only when several cards
    # are visible
    use_cache = plan_serving_modes(
        vp_mode=tristate(cfg.model.gpu.get("view_parallel", "auto")),
        cache_mode=tristate(cfg.this_main.get("ref_token_cache", "auto")),
        use_buckets=use_buckets,
        need_attn_weights=cfg.model.need_attn_weights,
        zero_reference=cfg.data.dataset.zero_reference,
        k_refs=int(cfg.data.neighbour_config.cross),
        n_dev=torch.cuda.device_count() if device.type == "cuda" else 1,
    )

    loader_kw = dict(
        batch_size=cfg.data.loader.validation.batch_size,
        num_workers=cfg.data.loader.validation.num_workers,
        prefetch_batches=cfg.data.loader.validation.prefetch_factor,
        seed=cfg.seed,
    )
    if use_buckets:
        loader = ShapeBucketedLoader(
            dataset, bucket_multiple=int(cfg.this_main.get("bucket_multiple", 112)), **loader_kw
        )
        print(f"shape-bucketed predict: {len(shapes)} item shapes -> "
              f"{len(loader.distinct_buckets())} bucket shape(s)")
    else:
        loader = Loader(dataset, shuffle=False, **loader_kw)

    mcfg = CrossScoreConfig.from_config(cfg)
    model = load_model_params(cfg, CrossScoreNet(mcfg, device=device))

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
        token_cache = RefTokenCache(
            lambda imgs, valid_hw=None: encoder(model, to_device(imgs), valid_hw),
            encode_batch=int(cfg.this_main.get("ref_token_cache_encode_batch", 16)),
            max_items=int(cfg.this_main.get("ref_token_cache_max_items", 2048)),
            persist_dir=cfg.this_main.get("ref_token_cache_dir"),
        )
        step_cached = make_predict_step_cached(model)
        print(f"reference-token cache: on (frozen backbone; decode-skip off"
              f"{'; bucketed' if use_buckets else ''})")

        def step(batch: dict) -> dict:
            nonlocal h2d_bytes
            vhw = batch.get("_valid_hw")
            tokens = token_cache.gather(batch["item_paths"]["reference/cross/imgs"],
                                        batch["reference/cross/imgs"], valid_hw=vhw)
            h2d_bytes += batch["query/img"].nbytes + tokens.numel() * tokens.element_size()
            return step_cached(to_device(batch["query/img"]), tokens.to(device, non_blocking=True), vhw)
    else:
        step_plain = make_predict_step(model, need_attn_weights=cfg.model.need_attn_weights,
                                       head_id=cfg.model.need_attn_weights_head_id)

        def step(batch: dict) -> dict:
            nonlocal h2d_bytes
            refs = batch.get("reference/cross/imgs")
            h2d_bytes += batch["query/img"].nbytes + (0 if refs is None else refs.nbytes)
            return step_plain(to_device(batch["query/img"]), None if refs is None else to_device(refs),
                              batch.get("_valid_hw"))

    max_batches = resolve_limit(cfg.trainer.limit_test_batches, loader.batches_per_epoch())

    def save_vis(batch_idx: int, batch: dict, outputs: dict) -> None:
        import matplotlib.pyplot as plt

        fig = visualiser.vis(batch, outputs)
        fig.savefig(out_dir / "vis" / f"r0_B{batch_idx:04}_b0.png")
        plt.close(fig)

    def process(batch_idx: int, batch: dict, outputs_dev: dict) -> None:
        # the device copy waits for the step; everything after is host-side
        outputs = {k: v.float().cpu().numpy() for k, v in outputs_dev.items()}
        vhw = batch.get("_valid_hw")
        if vhw is not None and np.ndim(vhw) == 2:
            # a bucket-packed batch (mixed item shapes): the consumers take
            # individually cropped B=1 slices
            for i, b1, o1 in iter_bucketed_items(batch, outputs):
                summariser.update(batch_input=b1, batch_output=o1)
                if i == 0 and vis_every > 0 and batch_idx % vis_every == 0:
                    save_vis(batch_idx, b1, o1)
                if writer is not None:
                    writer.write_out(b1, o1, local_rank=0, batch_idx=batch_idx, item_offset=i)
            return
        batch, outputs = crop_bucketed(batch, outputs)
        summariser.update(batch_input=batch, batch_output=outputs)
        if vis_every > 0 and batch_idx % vis_every == 0:
            save_vis(batch_idx, batch, outputs)
        if writer is not None:
            writer.write_out(batch, outputs, local_rank=0, batch_idx=batch_idx)

    # one-deep pipeline: dispatch batch i+1 before materialising batch i's
    # outputs, overlapping device work with host-side writing
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

    summariser.summarise()
    if use_cache:
        print(f"ref-token cache: {token_cache.hits} hits, {token_cache.misses} unique misses")
    per_batch = h2d_bytes / max(n_batches, 1) / 2**20
    print(f"predict: {n_maps} maps in {seconds:.3f} s = {n_maps / max(seconds, 1e-9):.2f} maps/s "
          f"(loader, device and writers in the loop); host-to-device {per_batch:.2f} MiB per batch")
    print(f"predict done: {n_batches} batches -> {out_dir}")
    return out_dir


def main(argv=None):
    return predict(parse_cli("default_predict", argv))


if __name__ == "__main__":
    main()
