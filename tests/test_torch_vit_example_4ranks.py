"""The port's ViT example against the reference example at 4 ranks: data
2 x pipeline 2 and pipeline 4, each schedule with and without double
buffering (see ``test_torch_vit_example.py`` for the method and the
tolerance), and ``main(argv)`` at the reference's interleaved smoke's
flags (``--schedule 1f1b --virtual-stages 2 --dp 2``) on 4 gloo ranks.
"""

import numpy as np
import pytest

import _torch_pp_worker as worker
from test_torch_vit_example import (check_gradient_scale, check_layout,
                                    layout_runs)


@pytest.fixture(scope="module", params=[(4, 2), (4, None)],
                ids=["dp2xpp2", "pp4"])
def runs(request, tmp_path_factory):
    world, dp = request.param
    return layout_runs(world, dp,
                       tmp_path_factory.mktemp(f"vit{world}_{dp}"))


@pytest.mark.parametrize("name", sorted(worker.vit_configs(None)))
def test_example_matches_reference(runs, name):
    check_layout(runs, name)


def test_gpipe_gradients_are_pipeline_size_times_1f1b(runs):
    check_gradient_scale(runs)


def test_interleaved_smoke_main(tmp_path):
    res = worker.spawn("vit_main", 4, tmp_path)
    assert "mesh: data=2 x pipeline=2 (+2 per-stage DP subgroups); " \
        "double_buffering=True" in res[0]["printed"]
    assert "epoch 0: loss" in res[0]["printed"]
    assert all(r["printed"] == "" for r in res[1:])
    # Every rank returns the same (data-mean) loss.
    assert np.isfinite(res[0]["loss"])
    assert all(r["loss"] == res[0]["loss"] for r in res)
