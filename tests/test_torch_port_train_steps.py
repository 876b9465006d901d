"""The port's SRModel (S1) steps against the JAX package's, on CPU (the
losses, schedules and checkpoints: `test_torch_port_train.py`; apart so
that the scheduler, `--dist loadfile`, starts this heavy case on a worker
of its own).

The run starts both frameworks from the same weights (the JAX init
carried over by `jax_to_torch`) and feeds both the same numpy batches;
losses, final parameters and EMA agree within 2e-3 relative (the bar of
`test_torch_parity.py`'s A/B run).
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_port_train import _batches, _opt

from vmambair_tpu.train import build_model as jax_build_model
from vmambair_torch.train import build_model
from vmambair_torch.utils.convert import jax_to_torch

torch.set_num_threads(1)


def _rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def test_sr_model_steps_match_jax(tmp_path):
    """4 steps of Adam (0.9, 0.99), EMA 0.999 and MultiStepLR (milestones
    inside the run) from the same init on the same batches. The channel
    scans' conv_cout.bias has an exact gradient of 0 (it shifts every
    channel before a mean-subtracting LayerNorm), which Adam turns into
    steps of up to about lr each way from rounding noise: it is held to
    the sum of the learning rates instead."""
    opt = _opt(tmp_path)
    jm = jax_build_model(opt)
    m = build_model(opt, device="cpu")
    sd = jax_to_torch(jax.tree_util.tree_map(np.asarray, jm.params["params"]))
    m.net_g.load_state_dict(sd)
    m.net_g_ema.load_state_dict(sd)
    lr_sum = 0.0
    for it, batch in enumerate(_batches(4), 1):
        jm.feed_data(batch)
        jm.optimize_parameters(it)
        m.feed_data(batch)
        m.optimize_parameters(it)
        lj, lt = float(jm.log_dict["l_pix"]), m.get_current_log()["l_pix"]
        assert abs(lt - lj) <= 2e-3 * abs(lj), (it, lt, lj)
        assert m.log_dict["lr"] == pytest.approx(jm.log_dict["lr"])
        lr_sum += m.log_dict["lr"]
    assert m.log_dict["lr"] == pytest.approx(5e-4)
    for name, tree, net in (("params", jm.params, m.net_g),
                            ("ema", jm.params_ema, m.net_g_ema)):
        ref = jax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                  tree["params"]))
        for k, v in net.state_dict().items():
            if k.endswith("conv_cout.bias"):
                assert (v - ref[k]).abs().max() <= lr_sum, (name, k)
                continue
            assert _rel(v, ref[k]) <= 2e-3, (name, k, _rel(v, ref[k]))
        # the weights moved: the comparison is not of the init
        assert any(_rel(v, sd[k]) > 1e-4 for k, v in net.state_dict().items())
