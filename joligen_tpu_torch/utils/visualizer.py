"""Training observability: loss_log.txt, losses.json/metrics.json persistence
and an HTML gallery (``joligen_tpu/utils/visualizer.py``, reference
util/visualizer.py:55-716), numpy and PIL only. The visdom and aim display
adapters are not ported (ROADMAP Queue 1 item 16): ``output_display_type``
entries naming them are reported once and ignored."""

from __future__ import annotations

import json
import os
import time

import numpy as np


def tensor2im(arr):
    """NHWC float [-1,1] -> HWC uint8 (reference util/util.py tensor2im)."""
    a = np.asarray(arr)
    if a.ndim == 4:
        a = a[0]
    a = np.clip((a + 1.0) * 127.5, 0, 255).astype(np.uint8)
    if a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    return a


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(self.expr_dir, exist_ok=True)
        self.log_path = os.path.join(self.expr_dir, "loss_log.txt")
        self.losses_json = os.path.join(self.expr_dir, "losses.json")
        self.metrics_json = os.path.join(self.expr_dir, "metrics.json")
        self.img_dir = os.path.join(self.expr_dir, "web", "images")
        if not getattr(opt, "output_no_html", False):
            os.makedirs(self.img_dir, exist_ok=True)
        self.loss_history = self._load(self.losses_json)
        self.metric_history = self._load(self.metrics_json)
        servers = [t for t in (getattr(opt, "output_display_type", None)
                               or []) if t in ("visdom", "aim")]
        if servers:
            print(f"display {servers} not ported; writing loss_log.txt, "
                  "losses.json and the HTML gallery only")
        with open(self.log_path, "a") as f:
            f.write(f"================ Training Loss ({time.strftime('%c')}) ================\n")

    @staticmethod
    def _load(path):
        if os.path.exists(path):
            try:
                with open(path) as f:
                    return json.load(f)
            except json.JSONDecodeError:
                pass
        return []

    def log_losses(self, epoch, iters, losses):
        losses = {k: float(v) for k, v in losses.items()}  # sync here only
        msg = f"(epoch: {epoch}, iters: {iters}) " + " ".join(
            f"{k}: {v:.6f}" for k, v in losses.items())
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")
        self.loss_history.append({"epoch": epoch, "iters": iters, **losses})
        with open(self.losses_json, "w") as f:
            json.dump(self.loss_history, f)

    def log_metrics(self, epoch, iters, metrics):
        metrics = {k: float(v) for k, v in metrics.items()}
        self.metric_history.append({"epoch": epoch, "iters": iters, **metrics})
        with open(self.metrics_json, "w") as f:
            json.dump(self.metric_history, f)

    def save_images(self, visuals, epoch):
        """visuals: dict name -> NHWC array. Writes PNGs + refreshes
        index.html.
        output_num_images caps the per-call batch rows rendered; the HTML
        gallery refreshes at most every output_update_html_freq calls
        (reference visualizer options)."""
        html = not getattr(self.opt, "output_no_html", False)
        self._html_calls = getattr(self, "_html_calls", 0) + 1
        display_freq = max(1, getattr(self.opt, "output_display_freq", 1)
                           or 1)
        html_every = max(1, int(getattr(self.opt, "output_update_html_freq",
                                        display_freq) or display_freq)
                         // display_freq)
        nmax = int(getattr(self.opt, "output_num_images", 0) or 0)
        if html:
            from PIL import Image
        for name, arr in visuals.items():
            if nmax > 0 and getattr(arr, "ndim", 0) >= 4:
                arr = arr[:nmax]
            img = tensor2im(arr)
            if html:
                fn = f"epoch{epoch:03d}_{name}.png"
                Image.fromarray(img).save(os.path.join(self.img_dir, fn))
        if html and self._html_calls % html_every == 0:
            self._write_html()

    def _write_html(self):
        files = sorted(os.listdir(self.img_dir), reverse=True)
        rows = "\n".join(
            f'<div style="display:inline-block;margin:4px;text-align:center">'
            f'<img src="images/{f}" width="256"/><br/>{f}</div>'
            for f in files[:200])
        with open(os.path.join(self.expr_dir, "web", "index.html"), "w") as f:
            f.write(f"<html><body><h3>{self.opt.name}</h3>{rows}</body></html>")
