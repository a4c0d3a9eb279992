"""Precision / recall / F1 over distance thresholds (counterpart of
`hortimapping_tpu/metrics/precision_recall.py`).

Per instance: precision(t) = % of predicted points within t of the GT,
recall(t) = % of GT points within t of the prediction (strict `<`), F1 their
harmonic mean, on a linspace of thresholds; aggregates are per-threshold
means over instances. All thresholds are evaluated in one comparison of the
two nearest-neighbour distance arrays (`chamfer.nn_distances_np`).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import integrate

from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.metrics.chamfer import nn_distances_np
from hortimapping_tpu_torch.metrics.metric import Metrics3D


class PrecisionRecall(Metrics3D):
    def __init__(self, min_t: float, max_t: float, num: int,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.thresholds = np.linspace(min_t, max_t, num)
        self.reset()

    def reset(self) -> None:
        self.pr_list = []   # each entry: (num_thresholds,) precision %
        self.re_list = []
        self.f1_list = []

    def update(self, gt, pt) -> None:
        if self.prediction_is_empty(pt):
            z = np.zeros_like(self.thresholds)
            self.pr_list.append(z)
            self.re_list.append(z)
            self.f1_list.append(z)
            return
        gt_pts = self.convert_to_points(gt)
        pt_pts = self.convert_to_points(pt)
        d_pt_2_gt = nn_distances_np(pt_pts, gt_pts, self.device)   # precision direction
        d_gt_2_pt = nn_distances_np(gt_pts, pt_pts, self.device)   # recall direction
        p = 100.0 * np.mean(d_pt_2_gt[:, None] < self.thresholds[None, :], axis=0)
        r = 100.0 * np.mean(d_gt_2_pt[:, None] < self.thresholds[None, :], axis=0)
        denom = p + r
        f = np.where(denom > 0, 2.0 * p * r / np.where(denom > 0, denom, 1.0), 0.0)
        self.pr_list.append(p)
        self.re_list.append(r)
        self.f1_list.append(f)

    def compute_at_all_thresholds(self):
        pr = np.mean(np.stack(self.pr_list), axis=0)
        re = np.mean(np.stack(self.re_list), axis=0)
        f1 = np.mean(np.stack(self.f1_list), axis=0)
        return pr, re, f1

    def find_nearest_threshold(self, value: float) -> float:
        return self.thresholds[int(np.abs(self.thresholds - value).argmin())]

    def compute_at_threshold(self, threshold: float):
        idx = int(np.abs(self.thresholds - threshold).argmin())
        pr, re, f1 = self.compute_at_all_thresholds()
        return float(pr[idx]), float(re[idx]), float(f1[idx]), float(self.thresholds[idx])

    def compute_auc(self):
        """Simpson-integrated, normalised by the perfect predictor."""
        dx = self.thresholds[1] - self.thresholds[0]
        perfect = integrate.simpson(np.ones_like(self.thresholds), dx=dx)
        pr, re, f1 = self.compute_at_all_thresholds()
        return (
            integrate.simpson(pr, dx=dx) / perfect,
            integrate.simpson(re, dx=dx) / perfect,
            integrate.simpson(f1, dx=dx) / perfect,
        )
