"""kdualnum's range study in the port (`vmambair_torch/tools/kdualnum.py`)
against the TPU tool in `tools/`, on the CPU (kldio:
`test_torch_port_kldio_kdualnum.py`; apart so that the scheduler,
`--dist loadfile`, starts this heavy case on a worker of its own).

The TPU tool's `main` runs with `build_network` replaced by one that
builds MambaSISR6 at reduced depth (every level width, 48 to 384, at one
block; one refinement block), records the input and hands `apply` the
port's seeded weights carried to JAX (`scripts/convert_torch_weights.py`);
its watcher's captured calls are read from its closure. The port's
`collect` runs on the port's net and the same input. JAX's eager forward
of that net at 16x16 takes about a minute on one core; the full preset is
marked slow.

Tolerances: delta within 1e-5 (the forward differs from JAX's by the
order of fp32 sums), |A| = exp(A_log) within a relative 1e-6 (the two
exps' last bit), and the printed rows equal to the printed digits.
"""

import os
import sys

import numpy as np
import pytest
import torch
from test_torch_port_kldio_kdualnum import _load

import vmambair_tpu.models as jax_models
from vmambair_torch.models import build_network
from vmambair_torch.tools import kdualnum as port_kd

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
from convert_torch_weights import convert  # noqa: E402

torch.set_num_threads(1)
# reduced depth: one block at each level, one refinement block
REDUCED = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
# the kept calls of that net at 16x16: spatial pairs at levels 1 (the
# encoder, decoder and refinement blocks) and 2; channel scans of C >= 64
KDUALNUM_REDUCED_LINE = ("captured by kind: spatial 10 (L=64 x4, L=256 x6); "
                         "channel 7 (L=96 x4, L=192 x2, L=384 x1)")


def _jax_tool_run(monkeypatch, capsys, hw, net_kw):
    """The TPU tool's main on MambaSISR6 with `net_kw`, its weights those
    of the port's seeded init carried to JAX (`convert`): its printed
    lines, its watcher's captured (delta, |A|) per call, the port's net and
    the input. `init` returns the carried weights without running the
    JAX forward: the standalone tool's `init` runs the whole forward
    eagerly under its watcher, so it captures every call twice (the
    init's and the apply's, the same values)."""
    kd = _load("kdualnum")
    seen = {}
    build = jax_models.build_network

    class Recorder:
        def __init__(self, net):
            self.net = net

        def init(self, rng, x):
            seen["x"] = np.asarray(x)
            seen["net"] = build_network(dict(type="MambaSISR6", **net_kw),
                                        device="cpu").eval()
            return {"params": convert(seen["net"].state_dict())}

        def apply(self, *a, **kw):
            from vmambair_tpu.models import oss as oss_mod
            spy = oss_mod.selective_scan
            cells = dict(zip(spy.__code__.co_freevars, spy.__closure__))
            seen["stats"] = cells["stats"].cell_contents
            return self.net.apply(*a, **kw)

    monkeypatch.setattr(jax_models, "build_network",
                        lambda opt: Recorder(build(dict(opt, **net_kw))))
    monkeypatch.setenv("KDUALNUM_HW", str(hw))
    kd.main()
    return capsys.readouterr().out.splitlines(), seen


def _kdualnum_matches(monkeypatch, capsys, hw, net_kw):
    lines, seen = _jax_tool_run(monkeypatch, capsys, hw, net_kw)
    x = torch.from_numpy(np.ascontiguousarray(
        seen["x"].transpose(0, 3, 1, 2)))
    stats = port_kd.collect(seen["net"], x)
    jax_stats = seen["stats"]
    assert [s["delta"].shape[1] for s in stats] == [
        d.shape[1] for d, _ in jax_stats]
    for s, (d, absA) in zip(stats, jax_stats):
        assert s["delta"].shape == d.shape
        np.testing.assert_allclose(s["delta"], d, rtol=0, atol=1e-5)
        np.testing.assert_allclose(s["absA"], absA, rtol=1e-6, atol=0)
    assert {s["kind"] for s in stats} == {"spatial", "channel"}
    assert all(s["L"] >= port_kd.MIN_L for s in stats)
    # the TPU tool's capture line and its rows, to the printed digits
    assert lines == [f"captured {len(stats)} spatial scan calls (input "
                     f"{hw}x{hw})"] + port_kd.summarize(stats)
    return stats


def test_kdualnum_matches_the_jax_tool(monkeypatch, capsys):
    """Reduced depth, 16x16: the spatial pairs of L = 256 (levels 1 and
    the refinement) and 64 (level 2), and the channel scans of C = 96,
    192 and 384 (C = 48 is under 64)."""
    stats = _kdualnum_matches(monkeypatch, capsys, 16, REDUCED)
    assert port_kd.capture_line(stats) == KDUALNUM_REDUCED_LINE


@pytest.mark.slow
def test_kdualnum_full_preset_matches_the_jax_tool(monkeypatch, capsys):
    _kdualnum_matches(monkeypatch, capsys, 16, {})


def test_kdualnum_cli_lines(monkeypatch, capsys):
    """`main` on the CPU: the count by kind, the TPU tool's capture line,
    its three window rows and delta's row."""
    monkeypatch.setenv("KDUALNUM_HW", "16")
    monkeypatch.setattr(port_kd, "build_network", lambda opt, **kw:
                        build_network(dict(opt, **REDUCED), **kw))
    port_kd.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == KDUALNUM_REDUCED_LINE
    assert out[1] == "captured 17 spatial scan calls (input 16x16)"
    assert [line[:6] for line in out[2:]] == ["q=  32", "q=  64", "q= 128",
                                             "delta "]
