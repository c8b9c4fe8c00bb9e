"""The port's ``utils/profiling.py`` against the reference's on the CPU:
the ring-allreduce bus-bandwidth formula (``tests/test_utils.py``'s
case and a sweep), ``slope_time``/``median_slope`` on
runs with a known per-iteration cost and a constant overhead, ``sync``
returning its tree, and ``trace``/``annotate`` around a step."""

import json
import os

import pytest
import torch

from chainermn_tpu.utils import profiling as ref
from chainermn_tpu_torch.utils import profiling


def test_bus_bandwidth_formula():
    # 8 devices, 1 GB buffer, 0.1 s -> 2*(7/8) GB moved per chip / 0.1 s.
    got = profiling.allreduce_bus_bandwidth_gbs(1e9, 8, 0.1)
    assert abs(got - 17.5) < 1e-6
    for nbytes, n, s in [(1e9, 8, 0.1), (4 << 20, 4, 1e-3), (123, 1, 1.0),
                         (1e6, 2, 0.0), (1e6, 2, -1.0)]:
        assert profiling.allreduce_bus_bandwidth_gbs(nbytes, n, s) == \
            ref.allreduce_bus_bandwidth_gbs(nbytes, n, s)


def test_slope_time_cancels_a_constant():
    """``run(n)`` reports ``5 + 0.25 n`` seconds: the slope is 0.25 and
    the constant cancels, for both packages."""
    def run(n):
        return 5.0 + 0.25 * n

    assert profiling.slope_time(run, 4) == ref.slope_time(run, 4) == 0.25
    assert profiling.slope_time(run, 2, 3) == 0.25
    med, samples = profiling.median_slope(run, 3, repeats=5)
    assert med == 0.25 and samples == [0.25] * 5
    assert (med, samples) == ref.median_slope(run, 3, repeats=5)


def test_sync_returns_its_tree():
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), (torch.ones(3),)],
            "c": 3}
    assert profiling.sync(tree) is tree
    x = torch.ones(2)
    assert profiling.sync(x) is x


def test_trace_and_annotate(tmp_path):
    with profiling.trace(str(tmp_path)) as logdir:
        with profiling.annotate("chainermn_step"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert logdir == str(tmp_path)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    events = json.load(open(tmp_path / files[0]))["traceEvents"]
    assert any(e.get("name") == "chainermn_step" for e in events)


def test_trace_degrades_when_the_profiler_cannot_start(monkeypatch, tmp_path):
    import torch.profiler as tp

    def broken(*a, **kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(tp, "profile", broken)
    ran = []
    with profiling.trace(str(tmp_path / "t")) as logdir:
        ran.append(logdir)
    assert ran == [str(tmp_path / "t")]
    assert not (tmp_path / "t").exists()
