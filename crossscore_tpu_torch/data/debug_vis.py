"""Dataset debug driver: render loaded batches with crop boxes; the port's own
copy of ``crossscore_tpu/data/debug_vis.py`` (the same arrays and file names;
it needs matplotlib, so it runs where that is installed, not on the card's
machine).

Parity with the reference's executable ``__main__`` smoke drivers
(reference ``dataloading/dataset/nvs_dataset.py:477-718``): for each item it
renders (1) the loaded crop + score map + reference crops and (2) the original
images with the sampled crop rectangles overlaid.

CLI: ``python -m crossscore_tpu_torch.data.debug_vis <dataset_root> [--out DIR]``
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from crossscore_tpu_torch.data.crop import crop as crop_arr
from crossscore_tpu_torch.data.crop import get_crop_params
from crossscore_tpu_torch.data.nvs_index import NvsDataset


def debug_item(ds: NvsDataset, idx: int, rng: np.random.Generator) -> dict:
    """Like get_item but via the PIL path, also returning originals + crop params."""
    item_paths = ds.neighbour_selector.select(idx, rng)
    content = ds.load_content(item_paths)
    q, sm, refs = content["query/img"], content["query/score_map"], content["reference/cross/imgs"]
    debug = {"query/ori_img": q.copy(), "query/ori_score_map": sm.copy(),
             "reference/cross/ori_imgs": None if refs is None else refs.copy()}

    if ds.resize_short_side > 0:
        q, sm = ds._resize(q), ds._resize(sm)
        if refs is not None:
            refs = np.stack([ds._resize(r) for r in refs])
        debug["query/ori_img"], debug["query/ori_score_map"] = q.copy(), sm.copy()
        debug["reference/cross/ori_imgs"] = None if refs is None else refs.copy()

    if ds.query_crop is not None:
        p = get_crop_params(q.shape[:2], ds.query_crop.output_size, rng, ds.query_crop.deterministic)
        q, sm = crop_arr(q, p), crop_arr(sm, p)
        debug["query/crop_param"] = p
    else:
        debug["query/crop_param"] = np.array([0, 0, *q.shape[:2]])
    if ds.reference_crop is not None and refs is not None:
        params, outs = [], []
        for r in refs:
            p = get_crop_params(r.shape[:2], ds.reference_crop.output_size, rng,
                                ds.reference_crop.deterministic)
            outs.append(crop_arr(r, p))
            params.append(p)
        refs = np.stack(outs)
        debug["reference/cross/crop_param"] = np.stack(params)
    return {"query/img": q, "query/score_map": sm, "reference/cross/imgs": refs,
            "item_paths": item_paths, "debug": debug}


def render(item: dict, out_path: Path, vrange=(0, 1)) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    refs = item["reference/cross/imgs"]
    n_ref = 0 if refs is None else refs.shape[0]
    cols = max(3, n_ref)
    fig, axes = plt.subplots(3, cols, figsize=(3 * cols, 9))
    for ax in axes.flatten():
        ax.set_axis_off()

    axes[0][0].imshow(np.clip(item["query/img"], 0, 1))
    axes[0][0].set_title("query crop")
    axes[0][1].imshow(item["query/score_map"], vmin=vrange[0], vmax=vrange[1], cmap="turbo")
    axes[0][1].set_title("score map crop")

    dbg = item["debug"]
    axes[1][0].imshow(np.clip(dbg["query/ori_img"], 0, 1))
    axes[1][0].set_title("query original")
    i, j, h, w = dbg["query/crop_param"]
    axes[1][0].add_patch(Rectangle((j, i), w, h, lw=2, edgecolor="r", facecolor="none"))
    axes[1][1].imshow(dbg["query/ori_score_map"], vmin=vrange[0], vmax=vrange[1], cmap="turbo")
    axes[1][1].add_patch(Rectangle((j, i), w, h, lw=2, edgecolor="r", facecolor="none"))

    if refs is not None and dbg["reference/cross/ori_imgs"] is not None:
        for r_idx in range(n_ref):
            axes[2][r_idx].imshow(np.clip(dbg["reference/cross/ori_imgs"][r_idx], 0, 1))
            if "reference/cross/crop_param" in dbg:
                i, j, h, w = dbg["reference/cross/crop_param"][r_idx]
                axes[2][r_idx].add_patch(
                    Rectangle((j, i), w, h, lw=2, edgecolor="r", facecolor="none")
                )
            axes[2][r_idx].set_title(f"ref_{r_idx} original")

    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Render dataset debug figures with crop boxes")
    ap.add_argument("dataset_root")
    ap.add_argument("--resolution", default=None)
    ap.add_argument("--split", default="train")
    ap.add_argument("--out", default="debug/dataset")
    ap.add_argument("--n-items", type=int, default=5)
    ap.add_argument("--crop-size", type=int, default=518)
    ap.add_argument("--cross", type=int, default=5)
    ap.add_argument("--metric", default="ssim")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    ds = NvsDataset(
        dataset_path=args.dataset_root,
        resolution=args.resolution,
        data_split=args.split,
        neighbour_config={"strategy": "random", "cross": args.cross, "deterministic": False},
        metric_type=args.metric,
        metric_min=0,
        metric_max=1,
        crop_size=args.crop_size,
        crop_mode="dataset_default",
    )
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(min(args.n_items, len(ds))):
        rng = np.random.default_rng([args.seed, i])
        item = debug_item(ds, i, rng)
        render(item, out_dir / f"item_{i:03d}.png")
    print(f"{min(args.n_items, len(ds))} debug figures -> {out_dir}")


if __name__ == "__main__":
    main()
