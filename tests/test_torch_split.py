"""``CommunicatorBase.split`` by axis and ``split_devices``, against the
reference's contract (``chainermn_tpu/communicators/base.py:1195-1300``),
whose groups the reference's own objects give here on a mesh of as many
devices: ``split(("inter",))`` joins the ranks that share this rank's
``intra`` coordinate, ordered by their ``inter`` coordinate (and
``("intra",)`` the converse; both axes give the communicator again);
``split_devices(colors, keys)`` returns ``{color: communicator or
None}`` over every color in order of its lowest member, each group
ordered by ``(key, rank)``, ``None`` colors in no group.  On 4 gloo
ranks laid out 2 x 2 (workers from ``_torch_pp_worker.py``) and at one
rank in this process.
"""

import jax
import numpy as np
import pytest

import _torch_pp_worker as worker
from chainermn_tpu.communicators import build_mesh
from chainermn_tpu.communicators import create_communicator as jax_comm


def reference_groups(size, inter_size):
    """Flat device ranks of each reference group, as the port's
    ``members`` lists them for each rank."""
    mesh = build_mesh(inter_size=inter_size, intra_size=size // inter_size,
                      devices=jax.devices()[:size])
    comm = jax_comm("xla_ici", mesh=mesh)
    ids = {d.id: r for r, d in enumerate(mesh.devices.flatten())}
    intra = size // inter_size
    axis = {}
    for name, axes in (("inter", ("inter",)), ("intra", ("intra",)),
                       ("both", ("inter", "intra")), ("str", ("intra",))):
        sub = comm.split(axes)
        assert sub.axes == axes
        grid = np.arange(size).reshape(inter_size, intra)
        per_rank = {}
        for r in range(size):
            i, j = divmod(r, intra)
            per_rank[r] = (grid[:, j].tolist() if axes == ("inter",) else
                           grid[i, :].tolist() if axes == ("intra",) else
                           grid.ravel().tolist())
            assert len(per_rank[r]) == sub.device_size
        axis[name] = per_rank
    colors = [r % 2 for r in range(size)]
    colors[-1] = None
    subs = comm.split_devices(colors, [-r for r in range(size)])
    devices = {c: [ids[d.id] for d in np.asarray(s.mesh.devices).ravel()]
               for c, s in subs.items()}
    return axis, devices, type(jax_comm(
        "hierarchical", mesh=mesh).split(("inter",))).__name__


@pytest.mark.parametrize("size,inter_size", [(1, 1), (4, 2)])
def test_splits_match_reference(size, inter_size, tmp_path):
    if size == 1:
        res = [worker._splits(0, 1, 1)]
    else:
        res = worker.spawn("splits", size, tmp_path, inter_size=inter_size)
    axis, devices, hier = reference_groups(size, inter_size)
    for r, out in enumerate(res):
        for name, per_rank in axis.items():
            got = out[name]
            assert got["members"] == per_rank[r], (name, r)
            assert got["size"] == len(per_rank[r])
            assert got["cls"] == "XlaIciCommunicator"
            assert got["mean"] == pytest.approx(np.mean(per_rank[r]))
        d = out["devices"]
        assert d["colors"] == list(devices)
        for c, members in devices.items():
            want = members if r in members else None
            assert d["members"][str(c)] == want, (c, r)
        assert d["cls"] == (["XlaIciCommunicator"]
                            if any(r in m for m in devices.values()) else [])
        assert out["hier_inter"] == hier == "XlaIciCommunicator"


def test_split_refuses_unknown_axes_and_bad_lengths():
    from chainermn_tpu_torch import create_communicator

    comm = create_communicator("xla_ici", device="cpu")
    with pytest.raises(ValueError, match="axes"):
        comm.split(("data",))
    with pytest.raises(ValueError, match="length"):
        comm.split_devices([0, 1])
    with pytest.raises(ValueError, match="length"):
        comm.split_devices([0], keys=[0, 1])
