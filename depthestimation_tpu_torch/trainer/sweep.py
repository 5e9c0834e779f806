"""SweepTrainer: trains the curtain-response predictor.

Port of ``depthestimation_tpu/trainer/sweep.py``: the scaffolding of
``DefaultTrainer``; the validation metric is the masked mean absolute
error between the predicted peak image and the max-over-planes
ground-truth sweep intensity (a batch without a sweep compares with the
valid-depth mask), kept on the card until the end of the validation,
then taken over every data-parallel rank's batches.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from depthestimation_tpu_torch.parallel import mesh
from depthestimation_tpu_torch.trainer.default import DefaultTrainer


class SweepTrainer(DefaultTrainer):
    def _validate_with_gt(self):
        errors = []
        for batch in self._batches(self.val_loader):
            mi_l, dmi_l, dgt_l = self._side_inputs(batch, "left")
            self.ensure_state(mi_l)
            out = self._eval_step(self._with_prev(dmi_l, "left"))
            pred_peak = out["output_refined"][0][:, 0]          # [B, H, W]
            fi = dgt_l.get("feat_int_tensor")
            if fi is not None and fi.numel() > 0:
                gt_peak = fi.amax(dim=1) / 255.0
                mask = dgt_l["mask_tensor"][:, 0]
            else:
                gt_peak = dgt_l["masks_imgsizes"][:, 0]
                mask = torch.ones_like(gt_peak)
            errors.append(((pred_peak - gt_peak).abs() * mask).sum()
                          / torch.clamp(mask.sum(), min=1.0))
        # every rank's batches (data parallel), in rank order
        errors = mesh.all_gather_rows(np.asarray(
            torch.stack(errors).tolist() if errors else [], np.float64))
        mean_err = float(np.mean(errors)) if len(errors) else float("nan")
        self.save_model(mean_err)
        if self.id == 0:
            json_loc = os.path.join(self.save_root,
                                    self.cfg.data.exp_name + ".json")
            self.foutput.setdefault("peak_int_err", []).append(mean_err)
            with open(json_loc, "w") as f:
                json.dump(self.foutput, f)
        self._log.info(self.id, f"Val: peak_int_err={mean_err:.4f}")
        return [mean_err], ["peak_int_err"]
