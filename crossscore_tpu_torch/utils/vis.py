"""Colormap helpers + batch visualiser; the port's own copy of
``crossscore_tpu/utils/vis.py``.

Parity with reference ``utils/misc/image.py:36-73`` (gray2rgb / attn2rgb) and
``utils/plot/batch_visualiser.py`` (mosaic figures: query image, GT vs
predicted score map in turbo, reference grid, optional per-patch attention
maps with log-inverted softmax weights).

wandb is not assumed: visualisers return matplotlib figures; callers save them
as PNGs (tasks do) or forward to wandb when enabled. matplotlib is imported
only where a colormap or a figure is drawn, so rgb score maps and figures
need it and gray maps do not.
"""

from __future__ import annotations

import numpy as np

from crossscore_tpu_torch.io.images import u8, to_display_rgb


def gray2rgb(img: np.ndarray, vrange, cmap: str = "turbo") -> np.ndarray:
    """(H, W) float -> (H, W, 3) uint8 through a matplotlib colormap."""
    import matplotlib

    vmin, vmax = vrange
    norm = matplotlib.colors.Normalize(vmin=vmin, vmax=vmax)
    colormap = matplotlib.colormaps[cmap]
    return u8(colormap(norm(img))[:, :, :3])


def attn2rgb(attn_map: np.ndarray, cmap: str = "turbo") -> np.ndarray:
    """Log-inverted softmax attention weights -> uint8 RGB (reference
    ``utils/misc/image.py:54-73``)."""
    import matplotlib

    eps = 1e-8
    a = np.clip(attn_map, 0, 1) + eps
    a = np.clip(a, 0, 1)
    a = np.log(a) - np.log(eps)  # (0, -log(eps))
    norm = matplotlib.colors.Normalize(vmin=0, vmax=-np.log(eps))
    colormap = matplotlib.colormaps[cmap]
    return u8(colormap(norm(a))[:, :, :3])


class BatchVisualiserRef:
    """Mosaic: query image / GT map / predicted map + reference row."""

    def __init__(self, metric_type: str, metric_min: float, metric_max: float):
        self.metric_type = metric_type
        self.vrange = (metric_min, metric_max)

    def vis(self, batch: dict, outputs: dict, item: int = 0):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        refs = np.asarray(batch["reference/cross/imgs"][item])
        n_ref = refs.shape[0]
        cols = max(3, n_ref)
        fig, axes = plt.subplots(2, cols, figsize=(3 * cols, 6))
        for ax in axes.flatten():
            ax.set_axis_off()

        query = to_display_rgb(batch["query/img"][item])
        axes[0][0].imshow(np.clip(query, 0, 1))
        axes[0][0].set_title("query/img")
        if "query/score_map" in batch:
            axes[0][1].imshow(
                np.asarray(batch["query/score_map"][item]),
                vmin=self.vrange[0], vmax=self.vrange[1], cmap="turbo",
            )
            axes[0][1].set_title(f"gt/{self.metric_type}")
        pred = np.asarray(outputs["score_map_ref_cross"][item], dtype=np.float32)
        axes[0][2].imshow(pred, vmin=self.vrange[0], vmax=self.vrange[1], cmap="turbo")
        axes[0][2].set_title(f"pred/{self.metric_type}")

        for i in range(n_ref):
            axes[1][i].imshow(np.clip(to_display_rgb(refs[i]), 0, 1))
            axes[1][i].set_title(f"ref_{i}")

        fig.tight_layout()
        return fig


class BatchVisualiserRefAttnMap(BatchVisualiserRef):
    """Adds a row of centre-patch attention maps over each reference view."""

    def vis(self, batch: dict, outputs: dict, item: int = 0):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = super().vis(batch, outputs, item)
        if "attn_weights_map_ref_cross" not in outputs:
            return fig
        plt.close(fig)

        attn = np.asarray(outputs["attn_weights_map_ref_cross"][item], dtype=np.float32)
        gh, gw, n_ref = attn.shape[0], attn.shape[1], attn.shape[2]
        centre = attn[gh // 2, gw // 2]  # (K, gh, gw)

        refs = np.asarray(batch["reference/cross/imgs"][item])
        cols = max(3, n_ref)
        fig, axes = plt.subplots(3, cols, figsize=(3 * cols, 9))
        for ax in axes.flatten():
            ax.set_axis_off()

        query = to_display_rgb(batch["query/img"][item])
        axes[0][0].imshow(np.clip(query, 0, 1))
        axes[0][0].set_title("query/img")
        if "query/score_map" in batch:
            axes[0][1].imshow(np.asarray(batch["query/score_map"][item]),
                              vmin=self.vrange[0], vmax=self.vrange[1], cmap="turbo")
            axes[0][1].set_title(f"gt/{self.metric_type}")
        pred = np.asarray(outputs["score_map_ref_cross"][item], dtype=np.float32)
        axes[0][2].imshow(pred, vmin=self.vrange[0], vmax=self.vrange[1], cmap="turbo")
        axes[0][2].set_title(f"pred/{self.metric_type}")

        for i in range(n_ref):
            axes[1][i].imshow(np.clip(to_display_rgb(refs[i]), 0, 1))
            axes[1][i].set_title(f"ref_{i}")
            axes[2][i].imshow(attn2rgb(centre[i]))
            axes[2][i].set_title(f"attn_centre_{i}")

        fig.tight_layout()
        return fig


def make_visualiser(cfg):
    """Factory (parity with reference ``utils/plot/batch_visualiser.py:397-414``)."""
    m = cfg.model.predict.metric
    if cfg.model.need_attn_weights:
        return BatchVisualiserRefAttnMap(m.type, m.min, m.max)
    return BatchVisualiserRef(m.type, m.min, m.max)
