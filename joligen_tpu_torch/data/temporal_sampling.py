"""Temporal (video) frame-series sampling, copied from
``joligen_tpu/data/temporal_sampling.py`` (it imports no JAX; the port keeps
its own copy): datasets are
directories of frames (``vid_series/vid_series_#frame.png``); a sample is
``num_frames`` consecutive frames spaced by ``frame_step``. Valid start
indices are counted per series so a window never straddles two videos, and
the random start is drawn uniformly over all valid windows across series.
"""

from __future__ import annotations

import os
import random
from collections import OrderedDict


def validate_temporal_frame_step_random_max(frame_step, random_max):
    if random_max > 0 and random_max < frame_step:
        raise ValueError(
            "--data_temporal_frame_step_random_max must be 0 or >= "
            "--data_temporal_frame_step")


def temporal_valid_start_count(num_paths, num_frames, frame_step):
    return num_paths - (num_frames - 1) * frame_step


def build_temporal_series_index(paths, num_frames, frame_step):
    """Group frame paths by directory and compute, per series, how many
    window starts are valid. Returns (series_dirs, per_series_path_indices,
    flat list of (series_i, local_start) valid windows)."""
    series_dirs = list(OrderedDict.fromkeys(os.path.dirname(p) for p in paths))
    per_series = {d: [] for d in series_dirs}
    for i, p in enumerate(paths):
        per_series[os.path.dirname(p)].append(i)
    windows = []
    for si, d in enumerate(series_dirs):
        count = temporal_valid_start_count(len(per_series[d]), num_frames,
                                           frame_step)
        for start in range(max(0, count)):
            windows.append((si, start))
    return series_dirs, [per_series[d] for d in series_dirs], windows


def select_temporal_window(series_index, rng=None):
    """Uniformly pick one valid window; returns the list of global path
    indices of the window's frames, or None if no window fits."""
    rng = rng or random
    _dirs, per_series_idx, windows = series_index
    if not windows:
        return None
    si, start = windows[rng.randrange(len(windows))]
    return per_series_idx[si], start


class TemporalFrameStepMixin:
    """Random frame-step sampling (reference temporal_sampling.py:83-106)."""

    def _init_temporal_frame_step_sampling(self, opt):
        self.num_frames = int(getattr(opt, "data_temporal_number_frames", 5))
        self.frame_step = int(getattr(opt, "data_temporal_frame_step", 30))
        self.frame_step_random_max = int(
            getattr(opt, "data_temporal_frame_step_random_max", 0) or 0)
        validate_temporal_frame_step_random_max(self.frame_step,
                                                self.frame_step_random_max)

    def _sample_temporal_frame_step(self, rng=None):
        rng = rng or random
        if self.frame_step_random_max > 0:
            return rng.randint(self.frame_step, self.frame_step_random_max)
        return self.frame_step

    def _pick_window(self, paths, frame_step, rng=None):
        """Returns the global indices of num_frames frames, or None."""
        rng = rng or random
        index = build_temporal_series_index(paths, self.num_frames, frame_step)
        sel = select_temporal_window(index, rng)
        if sel is None:
            return None
        series_idx, start = sel
        return [series_idx[start + i * frame_step]
                for i in range(self.num_frames)]
