"""Training entry point, one rank per CUDA card; the port's counterpart of
``crossscore_tpu/tasks/train.py``.

    python -m crossscore_tpu_torch.tasks.train data.dataset.path=[<root>] alias=run1 \\
        trainer.max_epochs=9 trainer.optimizer.lr=5e-4 [this_main.train_recipe=token_fast]
    torchrun --nproc_per_node N -m crossscore_tpu_torch.tasks.train ...   # data parallel

``trainer.accelerator=cuda`` (the default) or ``cpu`` (the plain PyTorch
versions of every kernel). Several ranks (``torchrun``, ``--nnodes`` with
the rendezvous flags for several nodes; ``model.gpu.dist_backend`` nccl or
gloo) train data parallel, one node standing for one JAX process: each node
loads its shard of the index space (``data.loader.train.batch_size`` rows a
step, as each JAX process does), its ranks take contiguous blocks of those
rows, and the loss, the gradients and the metrics are the global batch's
(``train/step.py``). ``trainer.devices`` counts ranks (-1: every launched
rank). Rank 0 alone writes the run dir, the log, the checkpoints and the
profile. Each step is forward
(frozen backbone), L1 loss, backward (K4 for the decoder attention) and an
AdamW update. With ``this_main.token_space_train=true`` (or the
``token_fast`` recipe) the train batches are windows of full-image token grids
(``data/token_train.py``) and the step is the decoder-only graph; validation
stays on pixel crops; with the native decoder (``data/fastimage.py``) the
loader skips the decode of every image whose tokens are cached, so a run on
a warm store decodes only the score maps. Packed record shards are read with
``data.dataset.record_dir=<dir>`` (``python -m crossscore_tpu_torch.data.pack``).
Checkpoints (``io/checkpoint.py``) keep the model, the
optimiser, the scheduler and the exact loop cursor; resume with
``trainer.ckpt_path_to_load=<run_dir>/ckpt``. ``model.backbone.init_path``
loads the frozen backbone from a local torch file (a HuggingFace
``Dinov2Model`` state dict, or a reference Lightning checkpoint) over the
seeded init.

Rank 0 also draws the train-batch figure (``vis/train_s<step>.png``, every
``logger.vis_imgs_every_n_train_steps`` steps, pixel mode only) and the
first ``logger.cache_size.validation.n_fig`` validation batches
(``vis/val_e<epoch>_B<batch>.png``), and logs the 10-bin histograms of the
training forward's scores and L1 differences (``train/score_hist_<i>``,
``train/l1_diff_hist_<i>``, every ``logger.vis_histogram_every_n_train_steps``
steps) into ``metrics.jsonl``. Figures need matplotlib: a run that would
draw one without it stops before its first step; turn them off with
``logger.vis_imgs_every_n_train_steps=100000 logger.cache_size.validation.n_fig=0``.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from crossscore_tpu_torch.data.loader import Loader
from crossscore_tpu_torch.data.nvs_index import get_dataset, leaf_datasets
from crossscore_tpu_torch.data.token_cache import RefTokenCache
from crossscore_tpu_torch.data.token_train import TokenSpaceLoader, token_working_set
from crossscore_tpu_torch.io.checkpoint import CheckpointManager, load_hparams
from crossscore_tpu_torch.io.convert import init_params, load_backbone, load_into
from crossscore_tpu_torch.models import CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.models.crossscore import make_backbone_encoder
from crossscore_tpu_torch.tasks.common import (
    DataRanks, JsonlLogger, all_process_weighted_mean, config_diff, data_ranks, parse_cli, refuse_tensor_parallel,
    resolve_limit, save_config_snapshot, set_decode_skip, timestamp,
)
from crossscore_tpu_torch.train.optim import make_optimizer
from crossscore_tpu_torch.train.step import TrainState, batch_to_device, make_eval_step, make_train_step
from crossscore_tpu_torch.utils import compilation_cache
from crossscore_tpu_torch.utils.check_config import ConfigChecker
from crossscore_tpu_torch.utils.metric_logger import MetricLoggerScalar
from crossscore_tpu_torch.utils.vis import make_visualiser

# the overrides that turn every figure off, named by the startup check
FIGURES_OFF = ("logger.vis_imgs_every_n_train_steps=100000", "logger.cache_size.validation.n_fig=0")


def apply_train_recipe(cfg) -> str:
    """``this_main.train_recipe``: ``token_fast`` turns on token-space
    training (``this_main.token_space_train``) and uint8 pixels on the wire
    (``data.dataset.wire_uint8``), and sizes the token cache to the loader's
    in-flight working set. ``default`` and ``pixel`` change nothing; another
    name raises. Returns ``token_fast`` or ``default``. Whether the crop
    covers enough of the image for the token path is checked once the
    dataset is built (:func:`token_fast_coverage_guard`)."""
    recipe = str(cfg.this_main.get("train_recipe", "default") or "default")
    if recipe in ("default", "pixel"):
        return "default"
    if recipe != "token_fast":
        raise ValueError(f"unknown this_main.train_recipe {recipe!r}; expected default | pixel | token_fast")
    cfg.this_main.token_space_train = True
    cfg.data.dataset.wire_uint8 = True
    need = token_working_set(int(cfg.data.loader.train.prefetch_factor), int(cfg.data.loader.train.batch_size),
                             int(cfg.data.neighbour_config.cross))
    if int(cfg.this_main.get("ref_token_cache_max_items", 0)) < need:
        cfg.this_main.ref_token_cache_max_items = need
    print(f"train_recipe=token_fast: token-space training + uint8 wire, token cache sized >= {need} items",
          flush=True)
    return "token_fast"


def token_fast_coverage_guard(cfg, ds_train) -> bool:
    """True when the ``token_fast`` recipe keeps the token path, False (with
    a warning) to fall back to pixel crops: the crop's area over the
    (resized, trimmed) image, ``crop^2 / (H*W)``, must reach
    ``this_main.token_fast_min_coverage`` (0.6) on every leaf of the dataset,
    each probed once through ``get_item_shape`` (PNG headers only). The JAX
    package reads item 0 only, so a multi-root corpus whose other roots fall
    below the bound keeps the token path there. The JAX package's A/B runs
    set the bound: token matched pixel at 0.69 coverage and fell behind at
    0.45 and 0.16. ``this_main.token_space_train=true`` without the recipe
    is never second-guessed."""
    crop = int(cfg.data.transforms.crop_size)
    min_cov = float(cfg.this_main.get("token_fast_min_coverage", 0.6) or 0)
    leaves = [leaf for leaf in leaf_datasets(ds_train) if len(leaf)]
    if not leaves or min_cov <= 0:
        return True
    shapes = [leaf.get_item_shape(0) for leaf in leaves]
    cov, (h, w) = min((crop * crop / float(h * w), (h, w)) for h, w in shapes)
    if cov >= min_cov:
        return True
    warnings.warn(
        f"train_recipe=token_fast: the {crop}px crop covers only {cov:.0%} of the {h}x{w} image "
        f"(< token_fast_min_coverage={min_cov:.0%}), where the token path's full-image attention context "
        "lost quality in the JAX package's A/B runs (45% and 16% coverage); falling back to pixel crops. "
        "Set this_main.token_space_train=true to force the token path, or lower "
        "this_main.token_fast_min_coverage",
        RuntimeWarning, stacklevel=2)
    return False


def require_figure_backend(cfg, token_train: bool, last_step: int, validates: bool) -> None:
    """Raise before any step when the run would draw a figure and matplotlib
    cannot be imported: the train-batch figure when
    ``logger.vis_imgs_every_n_train_steps`` is within ``last_step``, the last
    step the run can reach (none in token mode), or the validation figures
    when ``logger.cache_size.validation.n_fig`` > 0 and the run validates.
    The histograms need no matplotlib."""
    every = int(cfg.logger.vis_imgs_every_n_train_steps)
    train_figs = not token_train and 0 < every <= last_step
    val_figs = validates and int(cfg.logger.cache_size.validation.n_fig) > 0
    if not (train_figs or val_figs):
        return
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            f"this run draws figures (logger.vis_imgs_every_n_train_steps={every}, "
            f"logger.cache_size.validation.n_fig={int(cfg.logger.cache_size.validation.n_fig)}), which need "
            f"matplotlib, and it cannot be imported ({e}); turn the figures off with {' '.join(FIGURES_OFF)}") from e


def train(cfg) -> Path | None:
    """Run the CLI on this rank; joins (and leaves) the launcher's process
    group when there are several ranks. Returns the run dir, the same on
    every rank of the data layout (None on a rank outside it)."""
    ConfigChecker(cfg).check_train_val()
    refuse_tensor_parallel(str(cfg.model.gpu.attention_impl))
    compilation_cache.enable()
    recipe = apply_train_recipe(cfg)
    with data_ranks(cfg, int(cfg.data.loader.train.batch_size), "train") as ranks:
        if not ranks.active:
            return None
        return _train(cfg, recipe, ranks)


def _train(cfg, recipe: str, ranks: DataRanks) -> Path:
    device = ranks.device
    if device.type == "cuda":
        # full fp32 for fp32 products and convolutions (cuDNN defaults to TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    main = ranks.is_main
    run_dir = Path(ranks.broadcast(str(Path(cfg.run.dir) / (f"{timestamp()}_{cfg.alias}" if cfg.alias
                                                             else timestamp()))))
    logger = None
    if main:  # rank 0 alone writes the run dir
        run_dir.mkdir(parents=True, exist_ok=True)
        save_config_snapshot(cfg, run_dir)
        logger = JsonlLogger(run_dir, cfg, use_wandb=bool(cfg.logger.get("use_wandb", False)))

    # ------------------------------------------------------------------ data
    overfit = cfg.trainer.overfit_batches
    deterministic_crop = overfit > 0
    # token-space training: the train dataset yields full images trimmed to
    # whole patches with their paths; the loader crops in token space.
    # Validation stays on pixel crops
    token_train = bool(cfg.this_main.get("token_space_train", False))
    ds_train = get_dataset(cfg, "train", crop_mode="integer_patches" if token_train else "dataset_default",
                           return_item_paths=token_train, resize_short_side=cfg.this_main.resize_short_side,
                           deterministic_crop=deterministic_crop)
    # the guard reads the files, so rank 0 decides for every rank
    if token_train and recipe == "token_fast" and not ranks.broadcast(
            token_fast_coverage_guard(cfg, ds_train) if main else None):
        token_train = cfg.this_main.token_space_train = False
        ds_train = get_dataset(cfg, "train", crop_mode="dataset_default",
                               resize_short_side=cfg.this_main.resize_short_side,
                               deterministic_crop=deterministic_crop)
    ds_val = get_dataset(cfg, "test", crop_mode="dataset_default",
                         resize_short_side=cfg.this_main.resize_short_side,
                         deterministic_crop=deterministic_crop)
    train_loader_kw = dict(
        batch_size=cfg.data.loader.train.batch_size,
        shuffle=cfg.data.loader.train.shuffle and overfit == 0,
        num_workers=cfg.data.loader.train.num_workers,
        prefetch_batches=cfg.data.loader.train.prefetch_factor,
        seed=cfg.seed,
        drop_last=True,
        **ranks.loader_kw(),
    )
    token_cache = None
    if token_train:
        # the encoder is bound to the model's frozen backbone once the model
        # is built and resumed (below); the loader encodes nothing before its
        # first epoch starts
        encode_cell: dict = {}
        token_cache = RefTokenCache(
            lambda imgs, valid_hw=None: encode_cell["fn"](imgs),
            encode_batch=int(cfg.this_main.get("ref_token_cache_encode_batch", 16)),
            max_items=int(cfg.this_main.get("ref_token_cache_max_items", 2048)),
            persist_dir=cfg.this_main.get("ref_token_cache_dir"),
        )
        loader_train = TokenSpaceLoader(ds_train, token_cache, crop_size=int(cfg.data.transforms.crop_size),
                                        deterministic_crop=deterministic_crop, **train_loader_kw)
        # the decode skip: the token path never reads the pixels of a cached
        # image (windows come from its tokens, supervision from the score
        # map), so the native path skips their decode. Exact: integer-patch
        # trims draw no rng. On a warm store (tasks.encode_tokens) only the
        # score maps are decoded from the first step on
        set_decode_skip(ds_train, token_cache, query=True)
    else:
        loader_train = Loader(ds_train, **train_loader_kw)
    # the data width is sized for the train batch; a validation batch it does
    # not divide is evaluated whole on every rank (the JAX CLI replicates it)
    val_bs = int(cfg.data.loader.validation.batch_size)
    val_split = val_bs % ranks.node_width == 0
    loader_val = Loader(
        ds_val,
        batch_size=val_bs,
        shuffle=cfg.data.loader.validation.shuffle,
        num_workers=cfg.data.loader.validation.num_workers,
        prefetch_batches=cfg.data.loader.validation.prefetch_factor,
        seed=cfg.seed + 1,
        # keep the final partial batch (reference torch DataLoader default
        # drop_last=False): its padded duplicates are weighted out of the
        # metrics through _valid, so every val sample is scored once
        drop_last=False,
        **(ranks.loader_kw() if val_split else dict(shard_index=ranks.node, num_shards=ranks.top.n_nodes)),
    )

    steps_per_epoch = loader_train.batches_per_epoch()
    limit_train = resolve_limit(cfg.trainer.limit_train_batches, steps_per_epoch)
    if limit_train is None:
        limit_train = steps_per_epoch
    if overfit > 0:
        limit_train = int(overfit)
    limit_val = resolve_limit(cfg.trainer.limit_val_batches, loader_val.batches_per_epoch())
    if limit_val is None:
        limit_val = loader_val.batches_per_epoch()
    last_step = int(cfg.trainer.max_epochs) * max(1, min(steps_per_epoch, limit_train))
    if cfg.trainer.max_steps > 0:
        last_step = min(last_step, int(cfg.trainer.max_steps))
    require_figure_backend(cfg, token_train, last_step,
                           (limit_val > 0 and cfg.trainer.max_epochs > 0) or cfg.trainer.num_sanity_val_steps > 0)

    # ----------------------------------------------------------------- model
    mcfg = CrossScoreConfig.from_config(cfg)
    model = load_into(CrossScoreNet(mcfg, device=device), init_params(mcfg, cfg.seed, device))
    if cfg.model.backbone.get("init_path"):  # a pretrained backbone over the seeded one
        load_backbone(model, cfg.model.backbone.init_path)
    # the epoch-interval StepLR counts the optimiser steps actually taken per
    # epoch (limit_train_batches/overfit shrink the epoch)
    actual_steps_per_epoch = max(1, min(steps_per_epoch, limit_train))
    optimizer, scheduler, lr_schedule = make_optimizer(cfg, model, actual_steps_per_epoch)
    state = TrainState()

    # every rank keeps the cadences; rank 0 alone writes
    ckpt_mgr = CheckpointManager(
        run_dir / "ckpt",
        train_time_interval_hours=cfg.trainer.checkpointing.train_time_interval,
        every_n_train_steps=cfg.trainer.checkpointing.every_n_train_steps,
        every_n_epochs=cfg.trainer.checkpointing.every_n_epochs,
        hparams=cfg.to_dict() if main else None,
    )
    start_epoch, start_batch = 0, 0
    if cfg.trainer.ckpt_path_to_load is not None:
        # a resume under a different config is legal (e.g. a new lr) but must
        # be loud: silent drift makes archived runs unreproducible
        old_hparams = load_hparams(cfg.trainer.ckpt_path_to_load) if main else None
        if old_hparams is not None:
            diffs = [d for d in config_diff(old_hparams, cfg.to_dict())
                     if not d.startswith(("alias:", "run.", "logger.", "trainer.ckpt_path_to_load:"))]
            if diffs:
                print("WARNING: resuming with a config that differs from the "
                      "checkpoint's hparams.yaml:\n  " + "\n  ".join(diffs))
        loop = CheckpointManager(cfg.trainer.ckpt_path_to_load, train_time_interval_hours=None).restore(
            model, optimizer, scheduler)
        state = TrainState(**loop)
        # the exact loop cursor from the checkpoint (not derived from the step
        # count, which drifts when limits or the dataset change between runs)
        start_epoch, start_batch = state.epoch, state.batch_in_epoch
        if start_batch >= actual_steps_per_epoch:
            start_epoch, start_batch = start_epoch + 1, 0
        print(f"{ranks.tag}resumed from step {state.step} (epoch {start_epoch}, batch {start_batch})")

    if token_train:
        # the backbone is frozen, so tokens of the resumed (or fresh) weights
        # stay valid for the whole run
        encoder = make_backbone_encoder(mcfg)
        encode_cell["fn"] = lambda imgs: encoder(model, torch.from_numpy(imgs).to(device))

    train_step = make_train_step(model, optimizer, scheduler)
    eval_step = make_eval_step(model, data_parallel=val_split)
    train_cache = {"loss": MetricLoggerScalar(cfg.logger.cache_size.train.n_scalar)}
    visualiser = make_visualiser(cfg)
    n_fig = int(cfg.logger.cache_size.validation.n_fig)
    fig_every = int(cfg.logger.vis_imgs_every_n_train_steps)
    hist_every = int(cfg.logger.vis_histogram_every_n_train_steps)

    def save_figure(host_batch: dict, pred: torch.Tensor, name: str, step: int | None = None) -> None:
        """Rank 0's figure of a batch's first item and its prediction."""
        import matplotlib.pyplot as plt

        fig = visualiser.vis(host_batch, {"score_map_ref_cross": pred.float().cpu().numpy()})
        (run_dir / "vis").mkdir(exist_ok=True)
        fig.savefig(run_dir / "vis" / name)
        if step is not None:
            logger.log_figure("train/batch_vis", fig, step)
        plt.close(fig)

    def run_validation(epoch: int, step: int, max_batches: int):
        if max_batches <= 0:
            return
        losses, corrs, weights = [], [], []
        for vb_idx, vbatch in enumerate(loader_val.epoch(epoch)):
            if vb_idx >= max_batches:
                break
            pred, metrics = eval_step(batch_to_device(vbatch, device))
            if main and vb_idx < n_fig:
                save_figure(vbatch, pred, f"val_e{epoch:03}_B{vb_idx:02}.png")
            losses.append(float(metrics["loss"]))
            corrs.append(float(metrics["correlation_cross"]))
            weights.append(float(vbatch["_valid"]))
        if losses:
            # weighted by the valid items of each batch and summed over the
            # ranks (the reference's self.log(sync_dist=True), task/core.py:449):
            # the mean covers every rank's rows. A collective
            loss, corr = all_process_weighted_mean([losses, corrs], weights, ranks.group, device)
        if losses and logger is not None:
            logger.log({
                "validation/loss": loss,
                "validation/loss_cross": loss,
                "validation/correlation_cross": corr,
                "validation/psnr_cross": float(-10 * np.log10(loss**2)) if loss > 0 else 99.0,
            }, step)

    # ------------------------------------------------------------------ loop
    max_steps = cfg.trainer.max_steps
    t_start = time.time()
    stop = False
    # profiling (reference PyTorchProfiler schedule wait=10 warmup=2
    # active=10, task/train.py:134-144): trace steps 12..22 as a chrome trace
    profile_window = (12, 22) if cfg.trainer.do_profiling and main else None
    profile_dir = Path(cfg.trainer.get("profile_dir") or (run_dir / "profiler"))
    profiler = None

    if cfg.trainer.num_sanity_val_steps > 0:
        run_validation(0, state.step, cfg.trainer.num_sanity_val_steps)

    pending_losses: list = []  # device scalars; pulled to the host at log cadence
    # sustained end-to-end throughput window (loader in the loop): warm up for
    # N steps, then time to the end of the run
    sustain_after = int(cfg.this_main.get("sustained_report_after_steps", 0) or 0) if main else 0
    sustain_t0 = sustain_s0 = None

    def ckpt_due(step: int, epoch_end: bool = False, epoch: int = 0) -> bool:
        """The same checkpoint decision on every rank (the JAX ``ckpt_due``):
        the step and epoch cadences are functions of (config, step); the
        wall-clock interval is rank 0's clock, broadcast at a coarse step
        cadence so that the loop does not pay a collective every step."""
        if ckpt_mgr.should_save(step, epoch_end=epoch_end, epoch=epoch, wall_clock=False):
            return True
        if not (epoch_end or step % 16 == 0):
            return False
        return bool(ranks.broadcast(main and ckpt_mgr.wall_clock_due()))

    def save() -> None:
        if main:
            ckpt_mgr.save(state.step, model, optimizer, scheduler, dataclasses.asdict(state))
    loop_steps = 0
    metrics: dict = {}

    for epoch in range(start_epoch, cfg.trainer.max_epochs):
        if state.epoch != epoch:  # a new epoch: reset the loop cursor
            state = TrainState(step=state.step, epoch=epoch, batch_in_epoch=0)
        epoch_start_batch = start_batch if epoch == start_epoch else 0
        for batch_idx, batch in enumerate(
            loader_train.epoch(0 if overfit else epoch, start_batch=epoch_start_batch),
            start=epoch_start_batch,
        ):
            if batch_idx >= limit_train:
                break
            host_batch, batch = batch, batch_to_device(batch, device)
            if profile_window and state.step == profile_window[0]:
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
                ] if device.type == "cuda" else [torch.profiler.ProfilerActivity.CPU])
                profiler.__enter__()
            state, metrics = train_step(state, batch)
            pred = metrics.pop("pred")
            loop_steps += 1
            if sustain_after and loop_steps == sustain_after:
                float(metrics["loss"])  # host fetch = device sync anchor
                sustain_t0, sustain_s0 = time.time(), state.step
            if profiler is not None and state.step == profile_window[1]:
                profiler.__exit__(None, None, None)
                profile_dir.mkdir(parents=True, exist_ok=True)
                profiler.export_chrome_trace(str(profile_dir / "trace.json"))
                profiler = None
                print(f"profiler trace written to {profile_dir}")

            # cache the loss every step (reference MetricLoggerScalar,
            # task/core.py:330-338) as a device scalar; one host pull per
            # logging cadence
            if main:
                pending_losses.append(metrics["loss"])
            if main and state.step % cfg.logger.vis_scalar_every_n_train_steps == 0:
                for x in torch.stack(pending_losses).cpu().numpy():
                    train_cache["loss"].update(float(x))
                pending_losses.clear()
                m = {k: float(v) for k, v in metrics.items()}
                logger.log({
                    "train/loss": train_cache["loss"].compute(),
                    "train/loss_cross": m["loss_cross"],
                    "train/psnr_cross": m["psnr_cross"],
                    "train/correlation_cross": m["correlation_cross"],
                    # the schedule's count at this update (state.step is one ahead)
                    "train/lr": float(lr_schedule(state.step - 1)),
                    "train/steps_per_sec": state.step / max(1e-9, time.time() - t_start),
                }, state.step)
            # the train-batch figure and the histograms from the training
            # forward's prediction (the reference reuses training_step's
            # outputs, task/core.py:312-362); token batches carry no pixels
            # to draw
            if main and not token_train and fig_every > 0 and state.step % fig_every == 0:
                save_figure(host_batch, pred, f"train_s{state.step:06}.png", state.step)
            if main and hist_every > 0 and state.step % hist_every == 0:
                p = pred.float().cpu().numpy()
                gt = np.asarray(host_batch["query/score_map"], np.float32)
                logger.log_histogram("train/score_hist", p, state.step)
                logger.log_histogram("train/l1_diff_hist", np.abs(p - gt), state.step)

            if ckpt_due(state.step):
                save()
            if max_steps > 0 and state.step >= max_steps:
                stop = True
                break
        if stop:
            break
        # Lightning semantics: validate when (epoch+1) % n == 0
        if (epoch + 1) % max(1, int(cfg.trainer.get("check_val_every_n_epoch", 1) or 1)) == 0:
            run_validation(epoch, state.step, limit_val)
        if ckpt_due(state.step, epoch_end=True, epoch=epoch):
            save()

    if profiler is not None:  # the run ended inside the window
        profiler.__exit__(None, None, None)
    if sustain_t0 is not None and state.step > sustain_s0:
        float(metrics["loss"])  # end-of-window sync anchor
        n = state.step - sustain_s0
        ms = (time.time() - sustain_t0) / n * 1e3
        print(f"sustained: {ms:.1f} ms/step over {n} steps (loader in loop)")
        logger.log({"train/sustained_ms_per_step": ms, "train/sustained_steps": n}, state.step)
    if cfg.trainer.checkpointing.save_last:
        save()
    if token_cache is not None:
        print(f"{ranks.tag}token cache: {token_cache.hits} hits, {token_cache.misses} misses, "
              f"{token_cache.disk_hits} disk hits")
        print(f"{ranks.tag}decode skip: {token_cache.skipped_decodes} images not decoded (their tokens were "
              "cached)")
    if logger is not None:
        logger.close()
    print(f"{ranks.tag}train done: {state.step} steps -> {run_dir}")
    return run_dir


def main(argv=None):
    return train(parse_cli("default", argv))


if __name__ == "__main__":
    main()
