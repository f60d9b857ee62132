"""Interactive registration GUI (optional; needs PyQt5 and matplotlib).

The counterpart of ``highresnet_tpu/registration/app.py``: a Qt front end
over the port's ``RegistrationSession``, which holds all registration
logic, so this module is widgets and signal wiring only: file-open dialogs
for the reference and template images and masks, arrow-key sub-pixel
nudging, the nine overlay modes, "Compute and Apply Shift" for every search
method with its parameter widgets, the metric-history plots, the VGG diff
heatmap tab and the multi-metric vote.

PyQt5 is imported only when a window is built; ``main`` raises a clear
error without it. ``main`` fixes the device's numerics
(``runtime.setup_device``) before any work; headless users drive
``RegistrationSession`` directly.
"""

from __future__ import annotations

import sys

from highresnet_tpu_torch.config import load_registration_config
from highresnet_tpu_torch.registration.session import (
    OVERLAY_MODES,
    SEARCH_METHODS,
    RegistrationSession,
)
from highresnet_tpu_torch.runtime import setup_device

# methods that take coarse-to-fine grid parameters
GRID_METHODS = ("NCC", "Perceptual Loss", "SSIM", "Mutual Information", "Mean L1 Error")


def _require_qt():
    try:
        from PyQt5 import QtCore, QtGui, QtWidgets  # noqa: F401

        return QtCore, QtGui, QtWidgets
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "The registration GUI requires PyQt5, which is not installed in "
            "this environment. Use highresnet_tpu_torch.registration.session."
            "RegistrationSession for the headless API."
        ) from e


def build_main_window(session: RegistrationSession):  # pragma: no cover - GUI glue
    QtCore, QtGui, QtWidgets = _require_qt()
    import numpy as np
    from matplotlib.backends.backend_qt5agg import FigureCanvasQTAgg

    from highresnet_tpu_torch.utils.display import plot_metrics_vs_shifts
    from highresnet_tpu_torch.utils.heatmap_canvas import HeatmapCanvas

    class MainWindow(QtWidgets.QMainWindow):
        def __init__(self):
            super().__init__()
            self.session = session
            self.setWindowTitle("highresnet_tpu_torch registration")
            central = QtWidgets.QWidget()
            layout = QtWidgets.QVBoxLayout(central)

            # -- file loading ------------------------------------------------
            files = QtWidgets.QHBoxLayout()
            for label, slot in (
                ("Load Reference…", self.on_load_reference),
                ("Load Reference Mask…", self.on_load_reference_mask),
                ("Load Template…", self.on_load_template),
                ("Load Template Mask…", self.on_load_template_mask),
            ):
                btn = QtWidgets.QPushButton(label)
                btn.clicked.connect(slot)
                files.addWidget(btn)
            layout.addLayout(files)

            # -- shift controls ----------------------------------------------
            controls = QtWidgets.QHBoxLayout()
            self.delta_x = QtWidgets.QLineEdit(f"{session.config['current_deltax']:.3f}")
            self.delta_y = QtWidgets.QLineEdit(f"{session.config['current_deltay']:.3f}")
            self.delta_x.editingFinished.connect(self.on_delta_edited)
            self.delta_y.editingFinished.connect(self.on_delta_edited)
            controls.addWidget(QtWidgets.QLabel("ΔX"))
            controls.addWidget(self.delta_x)
            controls.addWidget(QtWidgets.QLabel("ΔY"))
            controls.addWidget(self.delta_y)

            self.method = QtWidgets.QComboBox()
            self.method.addItems(SEARCH_METHODS)
            self.method.currentTextChanged.connect(self.on_method_changed)
            controls.addWidget(self.method)
            solve = QtWidgets.QPushButton("Compute and Apply Shift")
            solve.clicked.connect(self.on_solve)
            controls.addWidget(solve)
            vote = QtWidgets.QPushButton("Apply Best (vote)")
            vote.clicked.connect(self.on_vote)
            controls.addWidget(vote)
            reset = QtWidgets.QPushButton("Reset History")
            reset.clicked.connect(self.on_reset_history)
            controls.addWidget(reset)
            layout.addLayout(controls)

            # -- per-method parameters (reference: per-method option widgets)
            params = QtWidgets.QHBoxLayout()
            self.points_per_dim = QtWidgets.QSpinBox()
            self.points_per_dim.setRange(3, 21)
            self.points_per_dim.setValue(7)
            self.max_recursions = QtWidgets.QSpinBox()
            self.max_recursions.setRange(1, 20)
            self.max_recursions.setValue(10)
            self.n_keypoints = QtWidgets.QSpinBox()
            self.n_keypoints.setRange(50, 5000)
            self.n_keypoints.setValue(500)
            self._grid_widgets = [QtWidgets.QLabel("grid pts/dim"), self.points_per_dim,
                                  QtWidgets.QLabel("recursions"), self.max_recursions]
            self._orb_widgets = [QtWidgets.QLabel("keypoints"), self.n_keypoints]
            for w in self._grid_widgets + self._orb_widgets:
                params.addWidget(w)
            params.addStretch(1)
            layout.addLayout(params)

            # -- tabs: overlay / VGG diff heatmap / metric history plots ------
            self.tabs = QtWidgets.QTabWidget()

            overlay_page = QtWidgets.QWidget()
            overlay_layout = QtWidgets.QVBoxLayout(overlay_page)
            self.overlay_mode = QtWidgets.QComboBox()
            self.overlay_mode.addItems(OVERLAY_MODES)
            self.overlay_mode.currentTextChanged.connect(self.refresh)
            overlay_layout.addWidget(self.overlay_mode)
            self.canvas = HeatmapCanvas()
            overlay_layout.addWidget(self.canvas.widget())
            self.tabs.addTab(overlay_page, "Overlay")

            self.vgg_canvas = HeatmapCanvas()
            self.tabs.addTab(self.vgg_canvas.widget(), "VGG Diff")

            self.plots_holder = QtWidgets.QScrollArea()
            self.plots_holder.setWidgetResizable(True)
            self.tabs.addTab(self.plots_holder, "Metric History")
            self.tabs.currentChanged.connect(self.on_tab_changed)

            layout.addWidget(self.tabs)
            self.setCentralWidget(central)
            self.statusBar().showMessage("ready")
            self.on_method_changed(self.method.currentText())
            self.refresh()

        # -- file dialogs ----------------------------------------------------

        def _pick(self, title):
            path, _ = QtWidgets.QFileDialog.getOpenFileName(
                self, title, "", "Images (*.png *.tif *.tiff *.jpg *.npy);;All files (*)"
            )
            return path or None

        def on_load_reference(self):
            path = self._pick("Reference image")
            if path:
                self.session.load_reference(path)
                self.session.config["reference_image"] = path
                self.session.reset_history()
                self.refresh()

        def on_load_reference_mask(self):
            path = self._pick("Reference mask")
            if path and self.session.config.get("reference_image"):
                self.session.load_reference(self.session.config["reference_image"], path)
                self.session.config["reference_mask"] = path
                self.refresh()

        def on_load_template(self):
            path = self._pick("Template image")
            if path:
                self.session.load_template(path)
                self.session.config["template_image"] = path
                self.session.reset_history()
                self.refresh()

        def on_load_template_mask(self):
            path = self._pick("Template mask")
            if path and self.session.config.get("template_image"):
                self.session.load_template(self.session.config["template_image"], path)
                self.session.config["template_mask"] = path
                self.refresh()

        # -- controls ----------------------------------------------------------

        def on_method_changed(self, method):
            for w in self._grid_widgets:
                w.setVisible(method in GRID_METHODS)
            for w in self._orb_widgets:
                w.setVisible(method == "Point Matching")

        def on_delta_edited(self):
            try:
                self.session.config["current_deltax"] = float(self.delta_x.text())
                self.session.config["current_deltay"] = float(self.delta_y.text())
            except ValueError:
                pass
            self.refresh()

        def keyPressEvent(self, event):
            step_x = self.session.config["shift_step_x"]
            step_y = self.session.config["shift_step_y"]
            key = event.key()
            if key == QtCore.Qt.Key_Left:
                self.session.nudge(dx=-step_x)
            elif key == QtCore.Qt.Key_Right:
                self.session.nudge(dx=step_x)
            elif key == QtCore.Qt.Key_Up:
                self.session.nudge(dy=-step_y)
            elif key == QtCore.Qt.Key_Down:
                self.session.nudge(dy=step_y)
            else:
                return super().keyPressEvent(event)
            self.refresh()

        def _method_kwargs(self):
            method = self.method.currentText()
            if method in GRID_METHODS:
                return {
                    "points_per_dim": self.points_per_dim.value(),
                    "max_recursions": self.max_recursions.value(),
                }
            if method == "Point Matching":
                return {"n_keypoints": self.n_keypoints.value()}
            return {}

        def on_solve(self):
            dy, dx = self.session.compute_and_apply_shift(
                self.method.currentText(), **self._method_kwargs()
            )
            self.statusBar().showMessage(f"applied shift: dy={dy:.4f} dx={dx:.4f}")
            self.refresh()

        def on_vote(self):
            dy, dx = self.session.vote_best_shift()
            self.statusBar().showMessage(f"vote winner: dy={dy:.4f} dx={dx:.4f}")
            self.refresh()

        def on_reset_history(self):
            self.session.reset_history()
            self.refresh()

        # -- rendering ---------------------------------------------------------

        def on_tab_changed(self, index):
            if self.tabs.tabText(index) == "VGG Diff":
                self.refresh_vgg()
            elif self.tabs.tabText(index) == "Metric History":
                self.refresh_plots()

        def refresh(self):
            dy, dx = self.session.current_shift
            self.delta_x.setText(f"{dx:.3f}")
            self.delta_y.setText(f"{dy:.3f}")
            if self.session.ref_image is None or self.session.template_image is None:
                return
            self.canvas.show_image(np.asarray(self.session.overlay(self.overlay_mode.currentText())))
            self.on_tab_changed(self.tabs.currentIndex())

        def refresh_vgg(self):
            if self.session.ref_image is None or self.session.template_image is None:
                return
            self.vgg_canvas.show_heatmap(np.asarray(self.session.vgg_diff_heatmap()))

        def refresh_plots(self):
            h = self.session.history
            if not h["shift_x"]:
                return
            fig = plot_metrics_vs_shifts(
                h["shift_x"], h["shift_y"], h["ssim"], h["ml1e"], h["pl"],
                highlight_last=True, show=False,
            )
            self.plots_holder.setWidget(FigureCanvasQTAgg(fig))
            # plot_metrics_vs_shifts creates via pyplot, which registers the
            # figure globally; without closing, every refresh (each arrow-key
            # nudge) leaks a figure+canvas until matplotlib warns at 20
            import matplotlib.pyplot as plt

            plt.close(fig)

    return MainWindow()


def main(config_path: str = "config.json", device="cuda"):  # pragma: no cover - GUI glue
    device = setup_device(device)
    QtCore, QtGui, QtWidgets = _require_qt()
    cfg = load_registration_config(config_path)
    session = RegistrationSession(cfg, device=device)
    if cfg["reference_image"]:
        session.load_reference(cfg["reference_image"], cfg["reference_mask"] or None)
    if cfg["template_image"]:
        session.load_template(cfg["template_image"], cfg["template_mask"] or None)
    app = QtWidgets.QApplication(sys.argv)
    win = build_main_window(session)
    win.show()
    sys.exit(app.exec_())


if __name__ == "__main__":
    main()
