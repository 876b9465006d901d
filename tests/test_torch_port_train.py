"""The port's S1 training layer (losses, schedules, checkpoints) against
the JAX package's, on CPU, and the routing of a training step (SRModel's
steps against JAX's: `test_torch_port_train_steps.py`).

On the CPU the port's scans and GDFN run their plain versions inside the
same autograd Functions that launch the kernels on the card.
"""

import inspect
import logging

import numpy as np
import pytest
import torch

from vmambair_tpu.train import schedulers as jax_schedulers
from vmambair_torch import _build
from vmambair_torch.losses import build_loss
from vmambair_torch.models import build_network
from vmambair_torch.train import build_model, schedulers
from vmambair_torch.train.checkpoint import load_network, save_network

torch.set_num_threads(1)
TINY_G = {"type": "OSSNet", "dim": 8, "num_blocks": [1, 1, 1, 1],
          "num_refinement_blocks": 1, "scale": 4, "use_bias": False,
          "ln_bias": True}


def _opt(tmp_path, **train):
    t = {"total_iter": 10, "ema_decay": 0.999,
         "optim_g": {"type": "Adam", "lr": 2e-3, "weight_decay": 0,
                     "betas": [0.9, 0.99]},
         "scheduler": {"type": "MultiStepLR", "milestones": [2, 3],
                       "gamma": 0.5},
         "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                       "reduction": "mean"}}
    t.update(train)
    return {"name": "t", "model_type": "MambaSISRModel", "is_train": True,
            "scale": 4, "num_gpu": 1, "manual_seed": 0,
            "network_g": dict(TINY_G, scan_impl="xla"),
            "path": {"models": str(tmp_path), "training_states":
                     str(tmp_path)},
            "train": t, "val": {"window_size": 8}}


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"lq": rng.rand(2, 8, 8, 3).astype(np.float32),
             "gt": rng.rand(2, 32, 32, 3).astype(np.float32)}
            for _ in range(n)]


SCHEDULES = [
    ({"type": "MultiStepLR", "milestones": [5, 12], "gamma": 0.5}, {}),
    ({"type": "MultiStepRestartLR", "milestones": [4, 9], "gamma": 0.5,
      "restarts": [0, 10], "restart_weights": [1, 0.5]}, {}),
    ({"type": "CosineAnnealingRestartCyclicLR", "periods": [8, 12],
      "restart_weights": [1, 1], "eta_mins": [1e-4, 1e-6]}, {}),
    ({"type": "CosineAnnealingRestartLR", "periods": [10, 10],
      "restart_weights": [1, 0.5], "eta_min": 1e-6}, {}),
    ({"type": "LinearLR"}, {"total_iter": 20}),
    ({"type": "VibrateLR"}, {"total_iter": 20}),
    ({"type": "TrueCosineAnnealingLR"}, {"total_iter": 20}),
    ({"type": "ConstantLR"}, {"warmup_iter": 5}),
]


@pytest.mark.parametrize("sched,kw", SCHEDULES,
                         ids=[s["type"] for s, _ in SCHEDULES])
def test_schedules_match_jax(sched, kw):
    got = schedulers.build_scheduler(dict(sched), 2e-4, **kw)
    ref = jax_schedulers.build_scheduler(dict(sched), 2e-4, **kw)
    assert [got(s) for s in range(20)] == [ref(s) for s in range(20)]


@pytest.mark.parametrize("name,kw", [("L1Loss", {}), ("MSELoss", {}),
                                     ("CharbonnierLoss", {"eps": 1e-6}),
                                     ("PSNRLoss", {"toY": True})])
def test_losses_match_jax(name, kw):
    from vmambair_tpu.losses import build_loss as jax_build_loss

    rng = np.random.RandomState(1)
    a, b = (rng.rand(2, 6, 5, 3).astype(np.float32) for _ in range(2))
    ref = jax_build_loss(dict(type=name, loss_weight=0.5, **kw))(a, b)
    got = build_loss(dict(type=name, loss_weight=0.5, **kw))(
        torch.from_numpy(a).permute(0, 3, 1, 2),
        torch.from_numpy(b).permute(0, 3, 1, 2))
    assert float(got) == pytest.approx(float(ref), rel=1e-5)


def test_save_resume_takes_the_same_step(tmp_path):
    """save, then a new model loads the net and resumes the optimizer and
    EMA: one more step on each gives the same weights."""
    opt = _opt(tmp_path)
    opt["network_g"].pop("scan_impl")
    b1, b2 = _batches(2, seed=3)
    m = build_model(opt, device="cpu")
    m.feed_data(b1)
    m.optimize_parameters(1)
    m.save(epoch=0, current_iter=1)
    assert (tmp_path / "net_g_1.pth").exists()
    assert (tmp_path / "1.state").exists()
    assert not [p for p in tmp_path.iterdir() if p.name.startswith("tmp")]

    m2 = build_model(dict(opt, manual_seed=5), device="cpu")
    m2.load_net_g(str(tmp_path / "net_g_1.pth"))
    assert m2.resume_training(str(tmp_path / "1.state")) == {
        "iter": 1, "epoch": 0}
    for mm in (m, m2):
        mm.feed_data(b2)
        mm.optimize_parameters(2)
    for a, b in ((m.net_g, m2.net_g), (m.net_g_ema, m2.net_g_ema)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)


def test_mixup_clip_adamw_step_is_seeded():
    """The deraining options (mixup nested under mixing_augs, AdamW,
    global-norm clip): two models from one seed take the same step."""
    opt = _opt("unused", mixing_augs={"mixup": True, "mixup_beta": 1.2},
               optim_g={"type": "AdamW", "lr": 3e-4, "weight_decay": 1e-4,
                        "betas": [0.9, 0.999]},
               use_grad_clip=True, grad_clip=0.01)
    losses = []
    for _ in range(2):
        m = build_model(opt, device="cpu")
        assert m.mixup and isinstance(m.optimizer, torch.optim.AdamW)
        m.feed_data(_batches(1)[0])
        m.optimize_parameters(1)
        losses.append(m.get_current_log()["l_pix"])
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


def test_non_strict_load_skips_a_mismatched_shape(tmp_path, caplog,
                                                  monkeypatch):
    # `get_root_logger` turns propagation off; caplog hooks the root
    monkeypatch.setattr(logging.getLogger("vmambair_torch"), "propagate",
                        True)
    net = build_network(TINY_G, device="cpu", seed=1)
    sd = net.state_dict()
    key = "patch_embed.proj.weight"
    bad = dict(sd, **{key: torch.zeros(1, 2, 3, 3)})
    save_network(str(tmp_path / "n.pth"), bad)
    fresh = build_network(TINY_G, device="cpu", seed=2)
    before = fresh.state_dict()[key].clone()
    with pytest.raises(RuntimeError):
        load_network(str(tmp_path / "n.pth"), fresh, strict=True)
    with caplog.at_level(logging.WARNING, logger="vmambair_torch"):
        load_network(str(tmp_path / "n.pth"), fresh, "params_ema",
                     strict=False)
    assert "shape mismatch at " + key in caplog.text
    after = fresh.state_dict()
    assert torch.equal(after[key], before)
    other = "encoder_level1.0.attn.A_logs"
    assert torch.equal(after[other], sd[other])


def test_test_pads_to_window_and_crops():
    opt = _opt("unused")
    m = build_model(dict(opt, is_train=False), device="cpu")
    m.feed_data({"lq": np.random.RandomState(2).rand(1, 13, 11, 3).astype(
        np.float32)})
    m.test()
    assert m.output.shape == (1, 3, 52, 44)


def test_entry_points_default_to_cuda():
    assert inspect.signature(build_network).parameters[
        "device"].default == "cuda"
    assert inspect.signature(build_model).parameters[
        "device"].default == "cuda"
    from vmambair_torch.train.sr_model import SRModel

    assert inspect.signature(SRModel).parameters["device"].default == "cuda"


def test_kernel_wrappers_refuse_to_drop_a_gradient():
    """A kernel wrapper has no backward: where autograd would record the
    call it raises (on CUDA), instead of returning a detached result."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        _build.no_grad_needed("k", x, None)
    _build.no_grad_needed("k", x.detach(), None)
    with torch.no_grad():
        _build.no_grad_needed("k", x)


def test_training_step_routes_every_scan_and_gdfn_through_a_function(
        monkeypatch):
    """One training step, counted through spies on the kernel wrappers on
    CPU: the forward takes the carry-saving scans and the GDFN forward, the
    backward one scan backward per scan, none of the no-carry forwards;
    the counts equal chip_smoke.expected_launches(net, train=True)."""
    import chip_smoke
    from vmambair_torch.ops import cuda_effn, cuda_scan

    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    names = {"oss_scan_fused_fwd": "oss_scan_fused",
             "oss_scan_fused_fwd_carries": "oss_scan_fused_carries",
             "selective_scan_fwd": "selective_scan",
             "selective_scan_fwd_carries": "selective_scan_carries",
             "selective_scan_bwd": "selective_scan_bwd"}
    for fn in names:
        spy(cuda_scan, fn)
    spy(cuda_effn, "gdfn_residual_fwd")
    m = build_model(dict(_opt("unused"), network_g=dict(TINY_G, dim=40)),
                    device="cpu")
    m.feed_data(_batches(1)[0])
    m.optimize_parameters(1)
    got = {names.get(k, "gdfn_residual_fused"): v for k, v in calls.items()}
    want = {k: v for k, v in chip_smoke.expected_launches(
        m.net_g, train=True).items() if v}
    assert got == want
    assert want["selective_scan_bwd"] == (
        want["oss_scan_fused_carries"] + want["selective_scan_carries"])
