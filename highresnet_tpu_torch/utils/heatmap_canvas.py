"""Matplotlib heatmap canvas with a managed colorbar.

The port's own copy of ``highresnet_tpu/utils/heatmap_canvas.py``, host
code: render masked heatmaps and images with a single colorbar that is
reused (not re-stacked) across updates. Works headlessly (Agg) and embeds
in Qt when available.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class HeatmapCanvas:
    def __init__(self, figsize=(5, 5)):
        import matplotlib

        if not hasattr(matplotlib, "_called_from_test"):
            try:  # embed in Qt when available, else Agg
                from PyQt5 import QtWidgets  # noqa: F401

                matplotlib.use("Qt5Agg", force=False)
            except ImportError:
                matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        self.fig = plt.figure(figsize=figsize)
        self.ax = self.fig.add_subplot(111)
        self._colorbar = None
        self._image = None

    def widget(self):
        """The Qt widget (FigureCanvas) when running under Qt."""
        from matplotlib.backends.backend_qt5agg import FigureCanvasQTAgg

        return FigureCanvasQTAgg(self.fig)

    def show_heatmap(self, data: np.ndarray, mask: Optional[np.ndarray] = None, cmap="viridis"):
        """Draw a heatmap, masking out invalid pixels, reusing the colorbar."""
        shown = np.ma.masked_array(data, mask=(mask is not None) & ~np.asarray(mask, bool)) \
            if mask is not None else data
        self.ax.clear()
        self._image = self.ax.imshow(shown, cmap=cmap)
        self.ax.set_xticks([])
        self.ax.set_yticks([])
        if self._colorbar is None:
            self._colorbar = self.fig.colorbar(self._image, ax=self.ax, fraction=0.046)
        else:
            self._colorbar.update_normal(self._image)
        self.fig.canvas.draw_idle()

    def show_image(self, img: np.ndarray):
        """Draw an RGB/grayscale image without a colorbar."""
        self.ax.clear()
        self.ax.imshow(img, cmap=None if img.ndim == 3 else "gray")
        self.ax.set_xticks([])
        self.ax.set_yticks([])
        self.fig.canvas.draw_idle()

    def save(self, path: str, dpi: int = 120):
        self.fig.savefig(path, dpi=dpi, bbox_inches="tight")
