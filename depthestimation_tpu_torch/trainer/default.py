"""DefaultTrainer: the depth-training loop.

Port of ``depthestimation_tpu/trainer/default.py``:

- one train step per frame (both camera sides forward, the loss, one
  backward, one Adam update: ``parallel/train_step.py``);
- the video-batch recursion carries the quarter-res ``prev_output`` /
  ``prev_lc`` DPVs across frames on the card, resets them at
  ``frame_count == 0``, with optional ``self_recurse`` repeats on the same
  frame;
- the learning rate halves at the ``cfg.train.halflr`` epochs;
- validation (the per-frame eval loop with the ``prev_output`` and the
  simulated LC's ``prev_lc`` feedback) computes the low- and high-res
  KITTI depth metrics and the UF error batched over items on the card,
  appends them to the ``{exp}.json`` results file, checkpoints every
  epoch and keeps ``_model_best`` by rmse_refined.

The losses and metrics stay on the card until ``print_freq`` or the end of
the epoch or validation reads them; each batch moves to the card once and
its soft labels are made there. The draws (the ``prev_lc`` drops, the LC
simulator's noise, ``var.pnoise``) come from one ``torch.Generator`` on the
model's device, seeded with ``cfg.seed`` on rank 0 and from ``(cfg.seed,
rank)`` on the others: they cannot reproduce JAX's PRNG. The per-item
draws (the noise, the pose noise) differ between ranks; the ``prev_lc``
drop, one draw for the global batch in JAX, is rank 0's on every rank
(``BaseModelNet._drop_prev_lc``).
JAX's ``lax.scan`` routes (``tpu.scan_train``, ``tpu.scan_eval``) run
the same modules over the same frames; on the card they are this frame
loop, so the port ignores those keys (``config.IGNORED_TPU_KEYS``).

Data parallel (``parallel/mesh.py``; ``id`` is the rank): each rank
trains on its own trajectories, the ranks agree on the epoch's step count
before it (``global_min_steps``), vote on every batch whether to skip it
(``global_any``: a corrupted batch on any rank skips it on all), gather
the validation's per-frame errors so every rank reports the same metrics,
and meet at a barrier after each checkpoint and at each epoch's end. Rank
0 writes the checkpoints and the results file; the model is made rank
0's on every rank after it is built or loaded (``broadcast_state``).

With ``lc.real_lc_config`` a second,
real ``LightCurtain`` is built from that sensor bundle and the LC loop
leaves the step: after each step ``_run_lc`` fuses each side's refined
DPV, against the batch's recorded sweep (``lc_process_real``) where the
batch carries one, else with the simulator.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from depthestimation_tpu_torch.data.video_synthetic import (assemble_inputs,
                                                            to_device)
from depthestimation_tpu_torch.lc.curtain import LightCurtain
from depthestimation_tpu_torch.lc.process import lc_process
from depthestimation_tpu_torch.lc.process_real import lc_process_real
from depthestimation_tpu_torch.ops import dpv as dpv_ops
from depthestimation_tpu_torch.ops import metrics as metrics_ops
from depthestimation_tpu_torch.ops import ufield as ufield_ops
from depthestimation_tpu_torch.ops.geometry import add_noise_to_pose
from depthestimation_tpu_torch.parallel import mesh
from depthestimation_tpu_torch.parallel.train_step import (
    init_state, make_eval_step, make_train_step, set_learning_rate)
from depthestimation_tpu_torch.trainer import checkpoint as ckpt


def _soft_labels(dmaps: torch.Tensor, masks: torch.Tensor,
                 d_candi: torch.Tensor, variance: float) -> torch.Tensor:
    """Gaussian soft labels of the ground-truth depth, on its device.

    dmaps [B, H, W], masks [B, 1, H, W], d_candi [D] -> [B, D, H, W];
    masked-out pixels (0/0 columns) hold -1.
    """
    clamped = torch.clamp(dmaps, d_candi[0], d_candi[-1]) * masks[:, 0]
    return dpv_ops.gen_soft_label(d_candi, clamped, variance,
                                  zero_invalid=True)


def fused_lc_fn(cfg, lc, uf_params):
    """The in-step light-curtain closure for ``make_train_step(...,
    lc_fn=...)``: ``(refined_l, refined_r, mi_l, mi_r, generator) ->
    (prev_lc_l, prev_lc_r)``.

    Both camera sides are stacked into ONE 2B-batch ``lc_process`` call
    (``cfg.lc.iterations``, ``cfg.lc.planner``, ``cfg.lc.params``) on an
    initialized ``LightCurtain``; the simulator's ground truth is the 4x
    nearest upsample of ``dmaps``, and the feedback is every 4th pixel of
    the fused log DPV. ``generator`` lives on the tensors' device (None:
    ``lc_process`` seeds one with 0)."""
    iters = int(cfg.lc.iterations)
    planner = cfg.lc.planner
    params = dict(cfg.lc.params)

    def lc_fn(refined_l, refined_r, mi_l, mi_r, generator=None):
        refined = torch.cat([refined_l, refined_r], dim=0)
        dmaps = torch.cat([mi_l["dmaps"], mi_r["dmaps"]], dim=0)
        dmaps_up = dmaps.repeat_interleave(4, dim=-2).repeat_interleave(
            4, dim=-1)
        intr = torch.cat([mi_l["intrinsics_up"], mi_r["intrinsics_up"]],
                         dim=0)
        out = lc_process(refined, dmaps_up, intr, lc, uf_params,
                         iterations=iters, planner=planner, params=params,
                         generator=generator)[:, :, ::4, ::4]
        b = refined_l.shape[0]
        return out[:b], out[b:]

    return lc_fn


_NO_PREV = {"left": None, "right": None}
_METRIC_KEYS = ("rmse", "rmse_refined", "sil", "sil_refined", "rmse_unc")


def rank_seed(seed: int, rank: int) -> int:
    """The generator seed of ``rank``: ``seed`` itself on rank 0 (a single
    process draws what it always drew), a distinct stream on the others,
    so ranks do not draw the same per-item noise (the LC simulator's,
    ``var.pnoise``)."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)])
               .generate_state(1, np.uint64)[0] >> 1)


def _strip_prev(mi: dict) -> dict:
    return {k: v for k, v in mi.items() if k not in ("prev_output",
                                                      "prev_lc")}


class DefaultTrainer:
    def __init__(self, id, model, loss_func, logger, save_root, cfg,
                 train_loader=None, val_loader=None):
        self.id = id
        self.model = model
        self.loss_func = loss_func
        self._log = logger
        self.save_root = save_root
        self.cfg = cfg
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.device = next(model.parameters()).device

        v = cfg.var
        self.d_candi = dpv_ops.powerf(v.d_min, v.d_max, v.ndepth, v.qpower)
        self._d_candi_t = torch.as_tensor(self.d_candi, dtype=torch.float32,
                                          device=self.device)
        self.self_recurse = max(int(cfg.train.get("self_recurse", 1)), 1)
        self.clear_prev_on_recurse = bool(
            cfg.train.get("clear_prev_on_recurse", False))
        self.uf_params = ufield_ops.UFieldParams.for_dataset(
            cfg.data.dataset_path)

        self.state = None
        self._train_step = None
        self._eval_step = make_eval_step(model)
        self.i_epoch = 0
        self.i_iter = 0
        self.best_rmse = np.inf
        self.first_run = True
        self.foutput = {k: [] for k in _METRIC_KEYS}
        self.prev_output = dict(_NO_PREV)
        self.prev_lc = dict(_NO_PREV)
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(cfg.get("seed", 0), mesh.rank()))
        #: seconds of the last training epoch, and of it the wait on the
        #: loader (``_wait_total``: every wait, validation's too)
        self.epoch_seconds = self.loader_wait_seconds = 0.0
        self._wait_total = 0.0
        #: the last validation's five metrics (``_METRIC_KEYS``)
        self.last_metrics = None

        self.lc = None
        self.real_lc = None
        if cfg.lc.enabled:
            self.lc = LightCurtain(self.device)
        self.video_path = None
        self._video = None

        os.makedirs(save_root, exist_ok=True)

    # -- state management ---------------------------------------------------

    def ensure_state(self, sample_model_input=None):
        """Build the optimizer and the train step once, the model made
        rank 0's on every rank. The sample is not needed: the torch model
        already holds its weights."""
        if self.state is not None:
            return
        mesh.broadcast_state(self.model)
        self.state = init_state(self.model, self.cfg)
        self._train_step = make_train_step(self.loss_func,
                                           lc_fn=self._fused_lc_fn())
        n_params = sum(p.numel() for p in self.model.parameters())
        self._log.info(self.id, f"Initialized model: {n_params/1e6:.2f}M "
                                f"params on {self.device}")

    def _state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.state.optimizer.state_dict()}

    def resume(self, best: bool = False):
        """Restore the model, the optimizer and the epoch from ``_ckpt``
        (or ``_model_best``), and the ``{exp}.json`` history."""
        if self.state is None:
            raise RuntimeError("call ensure_state first")
        state, epoch = ckpt.load_checkpoint(
            self.save_root, self.cfg.data.exp_name, self._state_dict(),
            best=best, map_location=self.device)
        self.model.load_state_dict(state["model"])
        self.state.optimizer.load_state_dict(state["optimizer"])
        mesh.broadcast_state(self.model)
        self.i_epoch = epoch
        json_loc = os.path.join(self.save_root,
                                self.cfg.data.exp_name + ".json")
        if os.path.isfile(json_loc):
            with open(json_loc) as f:
                self.foutput = json.load(f)
        self._log.info(self.id, f"Resumed at epoch {epoch} (best={best})")

    def load_init_model(self, path: str):
        """Warm start from another experiment's checkpoint (parameters
        only, where key and shape match)."""
        state, _ = ckpt.load_checkpoint(
            os.path.dirname(path) or ".",
            os.path.basename(path).replace("_ckpt", "")
            .replace("_model_best", ""),
            best=path.endswith("_model_best"), map_location=self.device)
        own = {k: p.detach() for k, p in self.model.named_parameters()}
        self.model.load_state_dict(
            ckpt.restore_params_partial(own, state["model"]), strict=False)
        mesh.broadcast_state(self.model)

    # -- LC setup -----------------------------------------------------------

    @staticmethod
    def _load_lc_config(path: str) -> dict:
        """A sensor-parameter bundle: .json (process_lc_json'd) or the
        reference's .npy pickled dict."""
        if path.endswith(".json"):
            from depthestimation_tpu_torch.runtime.planner_runtime import (
                process_lc_json)
            with open(path) as f:
                return process_lc_json(json.load(f))
        return np.load(path, allow_pickle=True).item()

    def _ensure_lc(self, model_input):
        if self.lc is None or self.lc.initialized:
            return
        if "algo_lc_config" in self.cfg.lc:
            params = self._load_lc_config(self.cfg.lc.algo_lc_config)
            params = self.lc.expand_params(params, self.cfg, 128, 128, "_algo")
        else:
            params = self.lc.gen_params_from_model_input(model_input)
            params = self.lc.expand_params(params, self.cfg,
                                           self.cfg.var.ndepth,
                                           self.cfg.var.ndepth * 2)
        self.lc.init(params)
        # the real device of the recorded-sweep fusion, when the config
        # names its sensor bundle
        if "real_lc_config" in self.cfg.lc:
            self.real_lc = LightCurtain(self.device)
            rparams = self._load_lc_config(self.cfg.lc.real_lc_config)
            self.real_lc.init(self.real_lc.expand_params(
                rparams, self.cfg, 128, 128, "_real"))
        self._log.info(self.id, "Initialized light curtain"
                       + (" (+real sweep-fusion device)"
                          if self.real_lc is not None else ""))
        # the simulated LC loop runs inside the train step: rebuild it if
        # the state was made before the curtain
        if self.state is not None:
            self._train_step = make_train_step(self.loss_func,
                                               lc_fn=self._fused_lc_fn())

    def _fused_lc_fn(self):
        """The in-step LC loop closure (``fused_lc_fn``), or None: also
        None with a real device, whose fusion runs after the step
        (``_run_lc``) as its inputs exist on sweep batches only."""
        if self.lc is None or not self.lc.initialized or \
                self.real_lc is not None:
            return None
        return fused_lc_fn(self.cfg, self.lc, self.uf_params)

    def _run_lc(self, refined, mi):
        """plan -> sense -> fuse on the refined DPV; returns the 1/4-res
        log DPV feedback (``prev_lc``). With a real device and a batch
        that carries the recorded sweep ``sweep_arr_tensor`` [B, P, H, W,
        2] (z, intensity) the curtains sample that sweep
        (``lc_process_real``); otherwise the simulator senses them."""
        kw = dict(iterations=int(self.cfg.lc.iterations),
                  planner=self.cfg.lc.planner,
                  params=dict(self.cfg.lc.params), generator=self.generator)
        if self.real_lc is not None and "sweep_arr_tensor" in mi:
            sweep = mi["sweep_arr_tensor"]
            out = lc_process_real(refined, sweep[..., 0], sweep[..., 1],
                                  mi["intrinsics_up"], self.lc, self.real_lc,
                                  self.uf_params, **kw)
        else:
            dmaps_up = mi["dmaps"].repeat_interleave(4, dim=-2) \
                .repeat_interleave(4, dim=-1)
            out = lc_process(refined, dmaps_up, mi["intrinsics_up"], self.lc,
                             self.uf_params, **kw)
        return out[:, :, ::4, ::4]

    # -- data prep ----------------------------------------------------------

    def _side_inputs(self, batch, camside: str, train: bool = False):
        """(numpy model input, its tensors on the card, the gt tensors on
        the card without soft labels) of one camera side, each array moved
        once; in training ``var.pnoise`` > 0 perturbs the poses."""
        stereo = bool(self.cfg.var.get("stereo", False))
        mi, gt = assemble_inputs(batch, camside, stereo)
        moved = {}
        dmi = to_device(_strip_prev(mi), self.device, moved)
        dgt = to_device(gt, self.device, moved)
        pnoise = float(self.cfg.var.get("pnoise", 0.0) or 0.0)
        if train and pnoise > 0:
            dmi["src_cam_poses"] = add_noise_to_pose(
                self.generator, dmi["src_cam_poses"], pnoise)
        return mi, dmi, dgt

    def _with_soft_labels(self, gt):
        gt = dict(gt)
        var = float(self.cfg.var.softce)
        gt["soft_labels"] = _soft_labels(gt["dmaps"], gt["masks"],
                                         self._d_candi_t, var)
        gt["soft_labels_imgsize"] = _soft_labels(
            gt["dmap_imgsizes"], gt["masks_imgsizes"], self._d_candi_t, var)
        return gt

    def _batches(self, loader):
        """The loader's batches, as many as the rank with the fewest has
        (``global_min_steps``), timing the wait on each into
        ``_wait_total``."""
        it = iter(loader.enumerate(
            max_steps=mesh.global_min_steps(loader.epoch_length())))
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            self._wait_total += time.perf_counter() - t0
            if batch is None:
                return
            yield batch

    def _skip(self, batch, what: str = "batch") -> bool:
        """Whether to skip this batch: invalid here or on any other rank
        (the vote is a collective: every rank calls it for every
        batch)."""
        if not mesh.global_any(not batch.get("is_valid", True)):
            return False
        self._log.info(self.id, f"Corrupted Data! Skipping {what} "
                                f"{batch['batch_idx']+1} frame "
                                f"{batch['frame_count']+1}")
        return True

    def _log_step(self, batch, loss: torch.Tensor):
        if self.i_iter % int(self.cfg.train.get("print_freq", 10)) == 0:
            self._log.info(self.id,
                           f"Train batch {batch['batch_idx']+1}/"
                           f"{batch['nbatch']}, frame "
                           f"{batch['frame_count']+1}/{batch['traj_len']},"
                           f" epoch {self.i_epoch+1}/"
                           f"{self.cfg.train.epoch_num}, "
                           f"loss={loss.item():.5f}")

    # -- public API ---------------------------------------------------------

    def train(self):
        for epoch in range(self.i_epoch, int(self.cfg.train.epoch_num)):
            if epoch in list(self.cfg.train.get("halflr", [])):
                opt = self.state.optimizer
                lr = float(opt.param_groups[0]["lr"]) * 0.5
                set_learning_rate(opt, lr)
                self._log.info(self.id, f"Halved LR to {lr}")
            self._run_one_epoch()
            self.eval()

    def eval(self):
        """Validate (the per-frame loop; JAX's ``tpu.scan_eval`` rollout
        is the same recursion, see the module docstring)."""
        return self._validate_with_gt()

    # -- epochs -------------------------------------------------------------

    def _run_one_epoch(self):
        wait0, t0 = self._wait_total, time.perf_counter()
        losses = self._run_one_epoch_loop()
        losses = torch.stack(losses).tolist() if losses else []
        self._last_epoch_losses = losses
        self.i_epoch += 1
        self.epoch_seconds = time.perf_counter() - t0
        self.loader_wait_seconds = self._wait_total - wait0
        mean = float(np.mean(losses)) if losses else float("nan")
        self._log.info(self.id, f"Epoch done in {self.epoch_seconds:.1f}s "
                                f"(loader wait {self.loader_wait_seconds:.1f}"
                                f"s), mean loss {mean:.5f}")
        mesh.barrier(f"epoch_{self.i_epoch}")
        return mean

    def _run_one_epoch_loop(self) -> list:
        losses = []
        for batch in self._batches(self.train_loader):
            if self._skip(batch):
                continue
            if batch["frame_count"] == 0:
                self.prev_output = dict(_NO_PREV)
                self.prev_lc = dict(_NO_PREV)
            mi_l, dmi_l, dgt_l = self._side_inputs(batch, "left", True)
            _, dmi_r, dgt_r = self._side_inputs(batch, "right", True)
            dgt_l = self._with_soft_labels(dgt_l)
            dgt_r = self._with_soft_labels(dgt_r)
            self.ensure_state(dmi_l)
            self._ensure_lc(mi_l)

            for _ in range(self.self_recurse):
                self.state, loss, aux = self._train_step(
                    self.state, self._with_prev(dmi_l, "left"),
                    self._with_prev(dmi_r, "right"), dgt_l, dgt_r,
                    self.generator)
                self.prev_output = {"left": aux["prev_output_left"],
                                    "right": aux["prev_output_right"]}
                if "prev_lc_left" in aux:        # the in-step LC loop
                    self.prev_lc = {"left": aux["prev_lc_left"],
                                    "right": aux["prev_lc_right"]}
                elif self.real_lc is not None:   # the fusion after it
                    self.prev_lc = {
                        "left": self._run_lc(aux["refined_left"], dmi_l),
                        "right": self._run_lc(aux["refined_right"], dmi_r)}
            if self.clear_prev_on_recurse:
                self.prev_output = dict(_NO_PREV)
                self.prev_lc = dict(_NO_PREV)

            losses.append(loss)
            self.i_iter += 1
            self._log_step(batch, loss)
        return losses

    def _with_prev(self, dmi: dict, camside: str) -> dict:
        return {**dmi, "prev_output": self.prev_output[camside],
                "prev_lc": self.prev_lc[camside]}

    # -- validation ---------------------------------------------------------

    def _validate_with_gt(self):
        """Per-frame validation: the eval forward with the ``prev_output``
        (and the simulated LC's ``prev_lc``) feedback, ``self_recurse``
        times a frame, optional panels for ``--viz`` / ``--write_video``."""
        errors = ([], [], [])
        out = None
        for batch in self._batches(self.val_loader):
            if self._skip(batch, "val batch"):
                continue
            if batch["frame_count"] == 0:
                self.prev_output = dict(_NO_PREV)
                self.prev_lc = dict(_NO_PREV)
            mi_l, dmi_l, dgt_l = self._side_inputs(batch, "left")
            dgt_l = self._with_soft_labels(dgt_l)
            self.ensure_state(mi_l)
            self._ensure_lc(mi_l)

            for _ in range(self.self_recurse):
                out = self._eval_step(self._with_prev(dmi_l, "left"))
                refined = out["output_refined"][-1]
                self.prev_output = {"left": refined[:, :, ::4, ::4],
                                    "right": None}
                if self.lc is not None and self.lc.initialized:
                    with torch.inference_mode():
                        self.prev_lc = {"left": self._run_lc(refined, dmi_l),
                                        "right": None}

            if self.cfg.var.get("viz", False) or self.video_path:
                self._visualize(mi_l, dgt_l, out["output_refined"][-1])
            self._frame_metrics(out["output"][-1], out["output_refined"][-1],
                                dgt_l, errors)
        return self._finish_validation(*errors)

    def _frame_metrics(self, dpv, dpv_ref, dgt, errors):
        """The KITTI depth metrics of the low- and high-res depth and the
        UF error, for every item of one frame at once, left on the card."""
        dpv, dpv_ref = dpv.float(), dpv_ref.float()
        d_candi = self._d_candi_t
        dmax = float(self.d_candi[-1])
        depth = dpv_ops.dpv_to_depthmap(dpv, d_candi, log=True)
        depth_ref = dpv_ops.dpv_to_depthmap(dpv_ref, d_candi, log=True)
        masks, masks_up = dgt["masks"][:, 0], dgt["masks_imgsizes"][:, 0]
        e = metrics_ops.depth_error(
            depth * masks, torch.clamp(dgt["dmaps"], max=dmax))
        er = metrics_ops.depth_error(
            depth_ref * masks_up, torch.clamp(dgt["dmap_imgsizes"], max=dmax))
        uf_t, uf_p, _ = ufield_ops.compute_unc_field(
            dpv_ref, dgt["soft_labels_imgsize"], d_candi,
            dgt["intrinsics_up"], masks_up, self.uf_params)
        eu = ufield_ops.compute_unc_rmse(uf_t, uf_p, d_candi)
        for acc, x in zip(errors, (e, er, eu)):
            acc.append(x)

    def _finish_validation(self, errors, errors_refined, errors_unc):
        """The five metrics over every rank's per-frame errors (gathered in
        rank order, so every rank computes the same numbers); rank 0
        appends them to ``{exp}.json``. Then the checkpoint."""
        def cat(xs, shape):
            rows = (torch.cat(xs).detach().cpu().double().numpy() if xs
                    else np.zeros(shape, np.float64))
            return torch.from_numpy(mesh.all_gather_rows(rows))

        e, er = cat(errors, (0, 9)), cat(errors_refined, (0, 9))
        eu = cat(errors_unc, (0,))
        results = metrics_ops.eval_errors(e)
        results_refined = metrics_ops.eval_errors(er)
        error_list = [results["rmse"][0], results_refined["rmse"][0],
                      results["scale invariant log"][0],
                      results_refined["scale invariant log"][0],
                      float(np.nanmean(eu.numpy())) if len(eu) else np.nan]

        self.last_metrics = [float(v) for v in error_list]
        self.save_model(error_list[1])
        if self.id == 0:
            json_loc = os.path.join(self.save_root,
                                    self.cfg.data.exp_name + ".json")
            if self.first_run and self.i_epoch <= 1 and \
                    os.path.exists(json_loc):
                os.remove(json_loc)
            for value, name in zip(error_list, _METRIC_KEYS):
                self.foutput.setdefault(name, []).append(float(value))
            with open(json_loc, "w") as f:
                json.dump(self.foutput, f)
            self._tensorboard(_METRIC_KEYS, error_list)
        if self._video is not None:
            self._video.close()
            self._video = None
        self.first_run = False
        self._log.info(self.id, "Val: " + ", ".join(
            f"{k}={v:.4f}" for k, v in zip(_METRIC_KEYS, error_list)))
        return error_list, list(_METRIC_KEYS)

    def _visualize(self, mi, gt, dpv_ref):
        """Composite debug panel of item 0; appended to the
        ``--write_video`` MP4 when set."""
        from depthestimation_tpu_torch.utils import visual

        dpv0 = dpv_ref[0].float()
        uf, _ = ufield_ops.gen_ufield(
            dpv0, self._d_candi_t, gt["intrinsics_up"][0], self.uf_params,
            log=True)
        depth = dpv_ops.dpv_to_depthmap(dpv0, self._d_candi_t, log=True)
        panel = visual.make_panel(
            np.asarray(mi["rgb"][0, -1]), depth.cpu().numpy(),
            gt["dmap_imgsizes"][0].cpu().numpy(), uf.cpu().numpy(),
            max_depth=float(self.d_candi[-1]))
        if self.video_path:
            if self._video is None:
                self._video = visual.VideoWriter(self.video_path)
            self._video.append(panel)
        return panel

    def _tensorboard(self, keys, values):
        """Optional tensorboard scalars; off when no writer backend is
        available, but a transient write failure only skips this epoch."""
        if getattr(self, "_tb_off", False):
            return
        try:
            if getattr(self, "_tb", None) is None:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(self.save_root, "tb"))
        except Exception:
            self._tb_off = True  # backend unavailable: permanently off
            return
        try:
            for k, v in zip(keys, values):
                self._tb.add_scalar(k, float(v), self.i_epoch)
            self._tb.flush()
        except Exception as e:
            self._log.info(self.id, f"tensorboard write failed: {e}")

    def save_model(self, rmse_refined: float):
        """``_ckpt`` every validation; ``_model_best`` when rmse_refined
        is the lowest so far. Rank 0 writes; every rank then waits at a
        barrier, so none reads a checkpoint before it is complete."""
        if self.state is None:
            return
        is_best = rmse_refined < self.best_rmse
        if is_best:
            self.best_rmse = rmse_refined
        if self.id == 0:
            ckpt.save_checkpoint(self.save_root, self.cfg.data.exp_name,
                                 self._state_dict(), self.i_epoch, is_best)
        mesh.barrier("save_model")
