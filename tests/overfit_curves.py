"""The overfit protocol of ``tools/overfit_convergence.py`` through both train
CLIs on the CPU, in fp32, from the same initial weights: the JAX package's
``crossscore_tpu.tasks.train`` and the port's ``crossscore_tpu_torch.tasks.train``
(the port started from the JAX CLI's init), and the port from its own seeded
init as ``crossscore_tpu_torch.tools.overfit_convergence`` runs it. One batch
(B=4, K=2, 224 px crops) of a seeded 540x720 synthetic corpus, both packages
on their Pillow decoders; the train-batch correlation and L1 loss are read
from each run's ``metrics.jsonl``.

    python tests/overfit_curves.py --steps 300 --out /tmp/overfit_curves

It prints every 25th step of each run, the best correlation and the largest
difference of the two same-init curves, and writes ``<out>/curves.json``.
Not a test (pytest does not collect it): 300 steps take tens of minutes.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402

from crossscore_tpu.confsys import load_config as jax_load_config  # noqa: E402
from crossscore_tpu.data import fastimage as jax_fastimage  # noqa: E402
from crossscore_tpu.models import CrossScoreConfig as JaxConfig  # noqa: E402
from crossscore_tpu.models import CrossScoreNet as JaxNet  # noqa: E402
from crossscore_tpu.tasks.train import main as jax_main  # noqa: E402
from crossscore_tpu_torch.data import fastimage as port_fastimage  # noqa: E402
from crossscore_tpu_torch.data.synthetic import generate  # noqa: E402
from crossscore_tpu_torch.io.convert import state_dict_from_jax  # noqa: E402
from crossscore_tpu_torch.tasks import train as train_mod  # noqa: E402


def overrides(steps: int, crop: int) -> list[str]:
    """The overfit tool's overrides (both packages' tools give the same),
    with the loader on the PNGs and the figures off."""
    return [
        "trainer.accelerator=cpu",
        "data.dataset.path=[datadir]",
        "data.loader.train.batch_size=4",
        "data.loader.train.num_workers=2",
        "data.loader.validation.batch_size=4",
        "data.loader.validation.num_workers=1",
        "data.neighbour_config.cross=2",
        f"data.transforms.crop_size={crop}",
        "this_main.resize_short_side=-1",
        "trainer.overfit_batches=1",
        f"trainer.max_epochs={steps}",
        "trainer.num_sanity_val_steps=0",
        "trainer.limit_val_batches=0",
        "trainer.optimizer.lr=3e-4",
        "trainer.lr_scheduler.step_size=1000",
        "model.pos_enc.multi_view.req_grad=true",
        "model.predict.metric.min=-1",
        "logger.vis_scalar_every_n_train_steps=1",
        "logger.vis_imgs_every_n_train_steps=100000",
        "logger.vis_histogram_every_n_train_steps=100000",
        "logger.cache_size.validation.n_fig=0",
    ]


def curve(run_dir) -> list:
    rows = [json.loads(line) for line in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]
    return [(r["step"], r["train/loss_cross"], r["train/correlation_cross"]) for r in rows
            if "train/correlation_cross" in r]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--out", default="/tmp/overfit_curves")
    ap.add_argument("--runs", default="jax,port_jax_init,port_own_init")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    if not (out / "datadir" / "res_540" / "split.json").exists():
        generate(out / "datadir", hw=(540, 720), scenes_per_split={"train": 2, "val": 1, "test": 1},
                 n_train_imgs=8, n_test_imgs=4)
    jax_fastimage.available = lambda: False
    port_fastimage.available = lambda: False
    os.chdir(out)
    ov = overrides(args.steps, args.crop)
    jax_ov = ov + ["model.tpu.compute_dtype=float32"]
    port_ov = ov + ["model.gpu.compute_dtype=float32"]
    cfg = jax_load_config("default", jax_ov)
    shapes = (jnp.zeros((1, args.crop, args.crop, 3)), jnp.zeros((1, 2, args.crop, args.crop, 3)))
    params = jax.device_get(JaxNet(JaxConfig.from_config(cfg)).init(jax.random.PRNGKey(cfg.seed), *shapes)["params"])
    own_init = train_mod.init_params
    runs = {}
    for name in args.runs.split(","):
        t0 = time.time()
        if name == "jax":
            run_dir = jax_main(jax_ov + [f"alias={name}"])
        else:
            train_mod.init_params = own_init if name == "port_own_init" else (
                lambda mcfg, seed, device: state_dict_from_jax(params))
            run_dir = train_mod.main(port_ov + [f"alias={name}"])
        runs[name] = {"curve": curve(run_dir), "s": time.time() - t0}
        c = runs[name]["curve"]
        print(f"{name}: {len(c)} steps in {runs[name]['s']:.0f} s; best corr {max(x[2] for x in c):.4f}; "
              f"final step {c[-1][0]} L1 {c[-1][1]:.4f} corr {c[-1][2]:.4f}", flush=True)
        for s, loss, corr in c[24::25]:
            print(f"  {name} step {s:4d}: L1 {loss:.4f}  corr {corr:.4f}")
    if "jax" in runs and "port_jax_init" in runs:
        a, b = runs["jax"]["curve"], runs["port_jax_init"]["curve"]
        runs["same_init_max_diff"] = {"l1": max(abs(x[1] - y[1]) for x, y in zip(a, b)),
                                      "corr": max(abs(x[2] - y[2]) for x, y in zip(a, b))}
        print(f"jax against port_jax_init: {runs['same_init_max_diff']}")
    (out / "curves.json").write_text(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
