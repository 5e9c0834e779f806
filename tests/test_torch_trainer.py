"""The port's depth trainer and CLI against the JAX package, on
``configs/test_tiny.json`` (48x32, feature_dim 16, D 16, B 2, f32, exp7,
LC off, pnoise 0: JAX's PRNG draws cannot be reproduced in torch).

One JAX run (module fixture): ``DefaultTrainer`` from the JAX CLI's
synthetic loaders, one epoch of 8 Adam steps and its validation (the
``lax.scan`` rollout), then ``make_rollout`` on the validation frames.
From the same initial
weights (``weights.from_jax_params``) the port's trainer must give
- the 8 per-step losses at rtol 1e-3 (measured 8e-5: f32 reassociation
  through 8 Adam steps; tests/test_torch_train_step.py shows one step's
  gradients move 1-2% when the input moves by one part in 10^6);
- the final parameters, all of them as one vector, at rel-L2 1e-3
  (measured 9e-5) and their update over the epoch at rel-L2 0.1 (measured
  0.02: Adam's normalized steps flip where a gradient is near zero);
  BatchNorm keeps no running statistics here (``bn_avg`` false: batch
  statistics in eval too);
- the five validation metrics at rtol 2e-3 (measured 2e-4);
- the per-frame eval loop's DPVs, as probabilities, within 4e-4 of JAX's
  rollout (measured up to 1.2e-4, which the thread count moves; bf16
  rounding at p ~ 1/16 is 2.4e-4: two frames of the trained weights, the
  second fed the first's refined DPV; one forward of
  tests/test_torch_model.py holds 1e-4).
The torch side runs on one thread (module fixture): these tensors are too
small for more, and the suite's other workers share the cores.
Port-only pins (rule 1: the same torch ops in the same order, so equal
bits): an epoch and validation with ``tpu.scan_train`` / ``scan_eval``
set against one without (the port ignores them), ``self_recurse`` and
``clear_prev_on_recurse``. Then the CLI's train -> ``--resume`` ->
``--eval`` (and ``--viz
--write_video``) cycle through ``main(..., device="cpu")`` and
``NetRuntime(save_root=...)``, and the
LC-on epoch with pose noise (finite losses, ``prev_lc`` fed back).
"""

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as jtrain
from depthestimation_tpu.config import load_config as jload
from depthestimation_tpu.data.video_synthetic import (
    assemble_inputs as jassemble)
from depthestimation_tpu.losses import get_loss as jget_loss
from depthestimation_tpu.models import get_model as jget_model
from depthestimation_tpu.trainer import get_trainer as jget_trainer
from depthestimation_tpu.utils.logger import init_logger as jlogger
from depthestimation_tpu_torch import train as ttrain
from depthestimation_tpu_torch.config import load_config
from depthestimation_tpu_torch.data.video_synthetic import (assemble_inputs,
                                                            to_device)
from depthestimation_tpu_torch.losses import get_loss
from depthestimation_tpu_torch.models import get_model
from depthestimation_tpu_torch.parallel import train_step as ts
from depthestimation_tpu_torch.runtime.net_runtime import NetRuntime
from depthestimation_tpu_torch.trainer import checkpoint as ckpt
from depthestimation_tpu_torch.trainer.default import DefaultTrainer
from depthestimation_tpu_torch.trainer.factory import get_trainer
from depthestimation_tpu_torch.utils.logger import init_logger
from depthestimation_tpu_torch.weights import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "test_tiny.json")
KEYS = ("rmse", "rmse_refined", "sil", "sil_refined", "rmse_unc")
PER_FRAME = ("rgb", "src_cam_poses", "dmaps", "masks", "dmaps_up")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_trainer"))
    cfg = jload(CONFIG)
    train_loader, val_loader = jtrain.build_loaders(cfg, True)
    tr = jget_trainer(cfg)(0, jget_model(cfg), jget_loss(cfg),
                           jlogger("t_trainer_jax", root), root, cfg,
                           train_loader, val_loader)
    frames = [jassemble(b, "left", False)[0] for b in val_loader.enumerate()]
    tr.ensure_state({**frames[0], "prev_output": None, "prev_lc": None})
    var0 = np_tree({"params": tr.state.params,
                    "batch_stats": tr.state.batch_stats})
    tr.train()
    var1 = np_tree({"params": tr.state.params,
                    "batch_stats": tr.state.batch_stats})
    # the rollout the scan validation compiled, on its two frames
    stacked = {k: jnp.asarray(np.stack([f[k] for f in frames]))
               for k in PER_FRAME}
    static = {k: jnp.asarray(v) for k, v in frames[0].items()
              if k not in PER_FRAME + ("prev_output", "prev_lc", "d_candi",
                                       "d_candi_up")}
    static["d_candi"] = frames[0]["d_candi"]
    static["d_candi_up"] = frames[0]["d_candi_up"]
    out = np_tree(tr._rollout_fn(var1, stacked, static, None, None))
    return {"var0": var0, "var1": var1, "losses": tr._last_epoch_losses,
            "metrics": {k: tr.foutput[k][-1] for k in KEYS},
            "frames": frames, "rollout": out}


def port_model(variables, nmode="exp7"):
    cfg = load_config(CONFIG)
    cfg.var.nmode = nmode
    model = get_model(cfg, "cpu")
    model.load_state_dict(from_jax_params(variables))
    return model


def port_trainer(model, root, **tpu):
    cfg = load_config(CONFIG)
    cfg["tpu"] = dict(tpu)
    train_loader, val_loader = ttrain.build_loaders(cfg, True)
    tr = get_trainer(cfg)(0, model, get_loss(cfg),
                          init_logger("t_trainer", str(root)), str(root),
                          cfg, train_loader, val_loader)
    tr.ensure_state()
    return tr


def rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def test_epoch_and_validation_match_jax(jax_run, tmp_path):
    model = port_model(jax_run["var0"])
    tr = port_trainer(model, tmp_path)
    assert isinstance(tr, DefaultTrainer) and tr.device.type == "cpu"
    assert tr.train_loader.epoch_plan() == jtrain.build_loaders(
        jload(CONFIG), True)[0].epoch_plan()
    tr.train()
    assert tr.i_epoch == 1 and tr.i_iter == 8
    np.testing.assert_allclose(tr._last_epoch_losses, jax_run["losses"],
                               rtol=1e-3)
    for k in KEYS:
        np.testing.assert_allclose(tr.foutput[k][-1], jax_run["metrics"][k],
                                   rtol=2e-3, err_msg=k)

    want, start = (from_jax_params(jax_run[v]) for v in ("var1", "var0"))
    own = model.state_dict()
    params = [k for k, _ in model.named_parameters()]
    assert set(own) == set(want)

    def flat(sd, keys):
        return torch.cat([sd[k].flatten() for k in keys])

    assert rel(flat(own, params), flat(want, params)) <= 1e-3
    upd = flat(own, params) - flat(start, params)
    upd_j = flat(want, params) - flat(start, params)
    assert rel(upd, upd_j) <= 0.1


def _port_frames(frames):
    return [to_device({k: v for k, v in f.items()
                       if k not in ("prev_output", "prev_lc")}, "cpu")
            for f in frames]


def test_eval_loop_matches_jax_rollout(jax_run):
    """JAX validates through its ``lax.scan`` rollout (``tpu.scan_eval``);
    the port's validation is the per-frame eval loop with the same
    ``prev_output`` recursion."""
    model = port_model(jax_run["var1"])
    dev = _port_frames(jax_run["frames"])
    step = ts.make_eval_step(model)
    prev, outs = None, []
    for mi in dev:
        o = step({**mi, "prev_output": prev, "prev_lc": None})
        prev = o["output_refined"][-1][:, :, ::4, ::4]
        outs.append(o)
    got = {k: torch.stack([o[k][-1] for o in outs])
           for k in ("output", "output_refined")}
    got["prev_output"] = prev
    want = jax_run["rollout"]
    assert got["output_refined"].shape == want["output_refined"].shape
    for k in got:
        np.testing.assert_allclose(np.exp(got[k].numpy()), np.exp(want[k]),
                                   rtol=0, atol=4e-4, err_msg=k)
    # no LC feedback: JAX's carry stays the model's log-uniform default
    np.testing.assert_allclose(want["prev_lc"], np.log(1 / 16), rtol=1e-6)


def test_tpu_scan_keys_are_ignored(jax_run, tmp_path):
    """``tpu.scan_train`` / ``scan_eval`` / ``scan_chunk`` pick JAX's
    ``lax.scan`` routes; the port runs its frame loop either way, to the
    bit (the same torch ops in the same order)."""
    got = []
    for scan in (False, True):
        knobs = dict(scan_train=True, scan_eval=True, scan_chunk=3) if scan \
            else dict(scan_eval=False)
        tr = port_trainer(port_model(jax_run["var0"]), tmp_path / str(scan),
                          **knobs)
        tr.train()
        got.append((tr._last_epoch_losses, tr.foutput, tr.model.state_dict()))
    assert got[0][0] == got[1][0] and len(got[0][0]) == 8
    assert got[0][1] == got[1][1]
    assert all(np.isfinite(got[0][1][k]).all() for k in KEYS)
    for k, v in got[0][2].items():
        assert torch.equal(v, got[1][2][k]), k
    assert ckpt.checkpoint_exists(str(tmp_path / "True"), "test_tiny",
                                  best=True)


def test_self_recurse_repeats_each_frame(tmp_path):
    """``train.self_recurse`` 2: two steps a frame on the same inputs, the
    second fed the first's ``prev_output``; ``clear_prev_on_recurse``
    drops the carry after each frame; validation takes the per-frame
    loop."""
    cfg = load_config(CONFIG)
    cfg.train.self_recurse = 2
    cfg.train.clear_prev_on_recurse = True
    train_loader, val_loader = ttrain.build_loaders(cfg, True)
    tr = DefaultTrainer(0, get_model(cfg, "cpu", seed=0), get_loss(cfg),
                        init_logger("t_recurse"), str(tmp_path), cfg,
                        train_loader, val_loader)
    tr.ensure_state()
    fed = []
    step = tr._train_step

    def recording(state, mi_l, *args):
        fed.append(mi_l["prev_output"] is not None)
        return step(state, mi_l, *args)

    tr._train_step = recording
    tr._run_one_epoch()
    assert tr.i_iter == 8 and tr.state.step == 16
    assert fed == [False, True] * 8
    assert tr.prev_output == {"left": None, "right": None}
    values, _ = tr.eval()
    assert np.isfinite(values).all()


def _sensor_json(w=48, h=32, d=16):
    intr = [[0.58 * w, 0, 0.5 * w], [0, 0.58 * w, 0.5 * h], [0, 0, 1]]
    return {"intr_rgb": intr, "intr_lc": intr, "dist_rgb": [0] * 5,
            "dist_lc": [0] * 5, "size_rgb": [w, h], "size_lc": [w, h],
            "rTc": np.eye(4).tolist(),
            "lTc": [[1, 0, 0, 0.2], [0, 1, 0, 0], [0, 0, 1, 0],
                    [0, 0, 0, 1]],
            "N": d, "s_range": 5.0, "e_range": 40.0, "q_power": 1.0,
            "laser_fov": 80.0, "laser_timestep": 2e-4}


def test_cli_train_resume_eval_cycle(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    raw = json.load(open(CONFIG))
    raw["data"]["exp_name"] = "cycle"
    path = str(tmp_path / "cycle.json")
    json.dump(raw, open(path, "w"))
    argv = ["--config", path, "--synthetic"]
    assert inspect.signature(ttrain.main).parameters["device"].default == \
        "cuda"

    first = ttrain.main(argv, device="cpu")
    save_root = os.path.join("outputs", "checkpoints", "cycle")
    results = os.path.join(save_root, "cycle.json")
    assert ckpt.checkpoint_exists(save_root, "cycle")
    assert ckpt.checkpoint_exists(save_root, "cycle", best=True)
    assert len(first._last_epoch_losses) == 8
    assert np.isfinite(first._last_epoch_losses).all()

    raw["train"].update(epoch_num=2, halflr=[1])
    json.dump(raw, open(path, "w"))
    second = ttrain.main(argv + ["--resume"], device="cpu")
    assert second.i_epoch == 2 and second.i_iter == 8   # one epoch: the 2nd
    lrs = {g["lr"] for g in second.state.optimizer.param_groups}
    assert lrs == {raw["train"]["lr"] * 0.5}            # halved at epoch 1
    hist = json.load(open(results))
    assert all(len(hist[k]) == 2 and np.isfinite(hist[k]).all()
               for k in KEYS)
    _, epoch = ckpt.load_checkpoint(save_root, "cycle")
    assert epoch == 2

    third = ttrain.main(argv + ["--eval"], device="cpu")
    assert third.cfg.train.batch_size == 1
    hist = json.load(open(results))
    assert all(len(hist[k]) == 3 for k in KEYS)
    # --eval restored _model_best, which the resumed epoch wrote (the best
    # resets on resume, as in JAX): its metrics are those of the resumed
    # trainer's weights validated at batch 1 (BatchNorm takes batch
    # statistics, so the batch-2 validation's items would differ)
    _, best_epoch = ckpt.load_checkpoint(save_root, "cycle", best=True)
    assert best_epoch == 2
    cfg1 = load_config(path)
    cfg1.train.batch_size = 1
    ref = DefaultTrainer(0, second.model, get_loss(cfg1),
                         init_logger("t_cycle_ref"), str(tmp_path / "ref"),
                         cfg1, val_loader=ttrain.build_loaders(cfg1, True)[1])
    want, _ = ref.eval()
    np.testing.assert_allclose([hist[k][-1] for k in KEYS], want, rtol=1e-4)

    # the per-frame validation with the debug panels (--viz, MP4 capture)
    ttrain.main(argv + ["--eval", "--viz", "--write_video", "v/e.mp4"],
                device="cpu")
    assert os.path.getsize(os.path.join("v", "e.mp4")) > 0
    np.testing.assert_allclose([json.load(open(results))[k][-1]
                                for k in KEYS], want, rtol=1e-4)

    state, _ = ckpt.load_checkpoint(save_root, "cycle", best=True)
    # --init_model: a warm start of another experiment from _model_best
    raw["data"]["exp_name"] = "warm"
    json.dump(raw, open(path, "w"))
    warm = ttrain.main(argv + ["--eval", "--init_model", os.path.join(
        save_root, "cycle_model_best")], device="cpu")
    for k, p in warm.model.named_parameters():
        assert torch.equal(p.detach(), state["model"][k]), k
    raw["data"]["exp_name"] = "cycle"
    json.dump(raw, open(path, "w"))
    cfg = load_config(path)
    rt = NetRuntime(cfg, _sensor_json(), mode="mono", save_root=save_root,
                    device="cpu")
    for k, v in rt.model.state_dict().items():
        assert torch.equal(v, state["model"][k]), k
    rgb = np.random.default_rng(0).random((3, 32, 48), np.float32)
    out = rt.process_frame(rgb)
    assert out["depth"].shape == (32, 48)
    assert torch.isfinite(out["depth"]).all()
    with pytest.raises(ValueError):
        NetRuntime(cfg, _sensor_json(), save_root=save_root,
                   state_dict=state["model"], device="cpu")


def test_lc_epoch_with_pose_noise(tmp_path, monkeypatch):
    """exp7_lc with ``--lc`` and ``var.pnoise``: port-only (JAX's draws
    cannot be reproduced): finite losses, the fused LC loop's ``prev_lc``
    fed back into the next step, pose noise drawn for both sides of each
    step, and the per-frame validation with the simulated LC."""
    from depthestimation_tpu_torch.trainer import default as tdefault
    monkeypatch.chdir(tmp_path)
    raw = json.load(open(CONFIG))
    raw["data"]["exp_name"] = "lc"
    raw["var"].update(nmode="exp7_lc", pnoise=0.05)
    path = str(tmp_path / "lc.json")
    json.dump(raw, open(path, "w"))

    noise_calls, fed = [], []
    real_noise = tdefault.add_noise_to_pose

    def counted_noise(gen, poses, level):
        noise_calls.append(level)
        return real_noise(gen, poses, level)

    real_make = tdefault.make_train_step

    def recording_make(loss_fn, lc_fn=None):
        step = real_make(loss_fn, lc_fn=lc_fn)

        def wrapped(state, mi_l, mi_r, gt_l, gt_r, gen):
            fed.append(mi_l["prev_lc"])
            return step(state, mi_l, mi_r, gt_l, gt_r, gen)
        return wrapped

    monkeypatch.setattr(tdefault, "add_noise_to_pose", counted_noise)
    monkeypatch.setattr(tdefault, "make_train_step", recording_make)
    tr = ttrain.main(["--config", path, "--synthetic", "--lc"], device="cpu")
    assert tr.lc is not None and tr.lc.initialized
    assert np.isfinite(tr._last_epoch_losses).all()
    assert noise_calls == [0.05] * 16
    # frame 0 of each trajectory starts from the default; the others take
    # the previous step's LC feedback
    assert [p is None for p in fed] == [f == 0 for _ in range(2)
                                        for f in range(4)]
    assert all(p.shape == (2, 16, 8, 12) and torch.isfinite(p).all()
               for p in fed if p is not None)
    hist = json.load(open(os.path.join("outputs", "checkpoints", "lc",
                                       "lc.json")))
    assert all(np.isfinite(hist[k][-1]) for k in KEYS)


def test_unported_paths_raise(tmp_path):
    cfg = load_config(CONFIG)
    assert get_trainer(cfg) is DefaultTrainer
    # the recorded-sweep fusion is ported: the real device is built with
    # the curtains (tests/test_torch_lc_real.py runs it)
    lc_cfg = load_config(CONFIG)
    lc_cfg.lc.enabled = True
    lc_cfg.lc.real_lc_config = "real_sensor.json"
    tr = DefaultTrainer(0, get_model(cfg, "cpu", seed=0), get_loss(cfg),
                        init_logger("t_unported"), str(tmp_path), lc_cfg)
    assert tr.real_lc is None and not tr.lc.initialized
    # the real-data loaders are ported (tests/test_torch_kitti.py): a
    # dataset directory takes the KITTI loader, which needs its split file,
    # as JAX's CLI does
    real = load_config(CONFIG)
    real.data.dataset_path = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="training.txt"):
        ttrain.build_loaders(real, False)
    jreal = jload(CONFIG)
    jreal.data.dataset_path = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="training.txt"):
        jtrain.build_loaders(jreal, False)
