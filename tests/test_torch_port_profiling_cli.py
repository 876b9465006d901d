"""The port's step profiler and console entry points on the CPU.

`train.profile_dir` makes `train_pipeline` trace its window (iterations
`profile_start` .. + `profile_iters`) with torch.profiler: a chrome trace
holding the window's operators and a table by class; a profiler that
cannot start raises; `mfu` divides by the H100's peaks. `python -m
vmambair_torch.train -opt <yaml> --device cpu` trains from the working
directory, and `cli.train_main` takes the same arguments.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
import yaml

from torch_dist_cases import tiny_train_opt
from vmambair_torch import cli
from vmambair_torch.train import pipeline
from vmambair_torch.utils import profiling
from vmambair_torch.utils.options import finalize_options

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def test_profile_dir_traces_its_window(tmp_path):
    opt = tiny_train_opt(tmp_path / "data", tmp_path / "exp", total_iter=4)
    trace = tmp_path / "trace"
    opt["train"].update(profile_dir=str(trace), profile_start=2,
                        profile_iters=2)
    pipeline.train_pipeline(str(tmp_path), finalize_options(
        opt, str(tmp_path)), device="cpu")
    assert sorted(os.listdir(trace)) == ["by_class.txt", "trace.json"]
    with open(trace / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the window's two steps: the forward's convolutions, the optimizer
    assert any("conv" in n for n in names)
    assert any("Adam" in n or "adam" in n for n in names)
    table = (trace / "by_class.txt").read_text().splitlines()
    assert table[0].split() == ["Name", "Where", "Calls", "Total", "ms"]
    assert any(r.startswith("aten::conv2d ") for r in table)


def test_event_totals_sum_what_key_averages_sums():
    """`event_totals`' host rows against `key_averages` for operators that
    no operator of the same name calls (the tree drops such nested
    repeats): the same calls and the same inclusive host time."""
    conv = torch.nn.Conv2d(3, 8, 3)
    lin = torch.nn.Linear(8, 4)
    x = torch.rand(2, 3, 16, 16)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            lin(conv(x).mean((2, 3))).sum().backward()
    rows = profiling.event_totals(prof)
    assert not any(card for _, card, _, _ in rows)
    assert [ms for *_, ms in rows] == sorted((ms for *_, ms in rows),
                                             reverse=True)
    got = {name: (n, ms) for name, _, n, ms in rows}
    want = {e.key: (e.count, e.cpu_time_total / 1e3)
            for e in prof.key_averages()}
    for name in ("aten::conv2d", "aten::linear", "aten::mean"):
        assert got[name][0] == want[name][0] == 3, name
        assert got[name][1] == pytest.approx(want[name][1], rel=1e-3,
                                             abs=2e-3), name
    table = profiling.totals_table(rows, limit=3).splitlines()
    assert len(table) == 4 and table[1].startswith(rows[0][0])


def test_profiler_that_cannot_start_raises(monkeypatch, tmp_path):
    class Refusing:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            raise RuntimeError("profiler refused")

    monkeypatch.setattr(torch.profiler, "profile", Refusing)
    prof = profiling.StepProfiler(str(tmp_path), start_iter=1, n_iters=1,
                                  device="cpu")
    with pytest.raises(RuntimeError, match="profiler refused"):
        prof.step(1)
    profiling.StepProfiler(None).step(1)  # no profile_dir: nothing


def test_mfu_divides_by_the_h100_peaks():
    assert profiling.mfu(989e12, 1.0) == pytest.approx(1.0)
    assert profiling.mfu(67e12, 2.0, "h100_fp32") == pytest.approx(0.5)
    assert set(profiling.PEAK_FLOPS) == {"h100_fp32", "h100_tf32",
                                         "h100_bf16"}


def test_python_m_vmambair_torch_train_on_the_cpu(tmp_path):
    opt = tiny_train_opt(tmp_path / "data", tmp_path / "exp", total_iter=1)
    yml = tmp_path / "tiny.yml"
    yml.write_text(yaml.safe_dump(opt))
    out = subprocess.run(
        [sys.executable, "-m", "vmambair_torch.train", "-opt", str(yml),
         "--device", "cpu"], cwd=str(tmp_path), capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert os.listdir(tmp_path / "exp" / "models") == ["net_g_1.pth"]
    # the library entry point takes the same arguments
    opt["path"]["experiments_root"] = str(tmp_path / "exp2")
    js = tmp_path / "tiny.json"
    js.write_text(json.dumps(opt))
    model = cli.train_main(["-opt", str(js), "--device", "cpu"])
    assert model.timers["iter"].count == 1
    assert os.listdir(tmp_path / "exp2" / "models") == ["net_g_1.pth"]
