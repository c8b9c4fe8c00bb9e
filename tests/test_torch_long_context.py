"""The port's long-context example against the reference example.

The reference's ``examples/long_context/train_lm.py`` runs as it is, its
``main(argv)`` on a mesh of as many CPU devices as the port has ranks
(its ``create_communicator`` given that mesh), with the jitted step
recorded: the initial parameters, each step's loss and the final
parameters.  The port's example (``LongContextLM``, one process a rank
on gloo, workers from ``_torch_sp_worker.py``) starts from those initial
parameters, converted by ``convert.flax_to_state_dict``, and takes the
same 3 steps on the same global batches (vocab 64, d_model 32, 4 heads,
d_ff 64, one layer, S 32, batch 4, fp32; ``LM_FLAGS``).  Here: world 1
(``--sp none`` plain, ``--packed --kv-heads 2 --window 8`` and
``--no-flash``); 2 ranks in ``test_torch_long_context_2ranks.py`` and 4
in ``test_torch_long_context_4ranks.py``.  Losses must agree within 1e-4
relative, and every final parameter tensor within 1e-4 relative L2, each
element within 1e-4 relative or 1.5e-5 absolute (5% of one AdamW step of
lr 3e-4: an element whose gradient cancels to its rounding may step
differently).  Under ``--vocab-tp`` each rank's table shard is held to
its rows of the reference's table.

Also: the reference's refusals (``SystemExit``) with its messages, the
example's ``main`` end to end, and a run stopped at a checkpoint and
resumed bit-identical to an uninterrupted one.
"""

import numpy as np
import pytest

import _torch_sp_worker as worker
from _lm_reference import _load_reference, check_config, layouts  # noqa: F401
from _lm_reference import reference_on


@pytest.mark.parametrize("name", sorted(worker.lm_configs(1)))
def test_example_matches_reference(layouts, name):
    check_config(layouts(1), name, 1)



REFUSALS = {
    "packed_no_flash": ["--packed", "--no-flash"],
    "window_zigzag": ["--sp", "zigzag", "--window", "4", "--dp", "1"],
    "window_no_flash": ["--window", "4", "--no-flash"],
    "sp_one_way": ["--sp", "ring"],
    "vocab_tp_none": ["--vocab-tp"],
    "vocab_tp_ckpt": ["--sp", "ring", "--vocab-tp", "--checkpoint-dir",
                      "/nonexistent"],
    "seq_len": ["--sp", "ring", "--seq-len", "33"],
    "zigzag_seq_len": ["--sp", "zigzag", "--seq-len", "34"],
    "ulysses_heads": ["--sp", "ulysses", "--n-heads", "3", "--d-model",
                      "30"],
    "kv_heads": ["--kv-heads", "3"],
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_reference(name):
    """The reference's ``SystemExit`` refusals, with its messages: at one
    rank for ``sp_one_way``, at two (one data row, a sequence of two)
    for the others."""
    from chainermn_tpu_torch.examples import train_lm as ex

    argv = worker.LM_FLAGS + REFUSALS[name]
    world = 1 if name in ("sp_one_way", "vocab_tp_none", "kv_heads",
                          "packed_no_flash", "window_no_flash") else 2
    ref = _load_reference()
    with reference_on(world), pytest.raises(SystemExit) as want:
        ref.main(argv)
    args = ex.parser().parse_args(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as got:
        ex._check(args, world)
    assert str(got.value) == str(want.value)


def test_main_end_to_end(capsys):
    from chainermn_tpu_torch.examples import train_lm as ex

    loss = ex.main(worker.LM_FLAGS + ["--device", "cpu", "--epochs", "2",
                                      "--packed"])
    out = capsys.readouterr().out
    assert "mesh: data=1 x seq=1; sp=none flash=True" in out
    assert out.count("epoch ") == 2 and np.isfinite(loss)


def test_resume_is_bit_identical(tmp_path, capsys):
    """Stopped after epoch 0 at a checkpoint and relaunched for 2 epochs,
    the packed run ends with the parameters of an uninterrupted 2-epoch
    run, bit for bit (the data stream is replayed)."""
    import re

    from chainermn_tpu_torch.examples import train_lm as ex

    common = worker.LM_FLAGS + ["--device", "cpu", "--packed",
                                "--checkpoint-every", "2"]
    common[common.index("--steps-per-epoch") + 1] = "4"

    def digest(out):
        m = re.search(r"params_digest ([0-9a-f]{8})", out)
        assert m, out
        return m.group(1)

    ex.main(common + ["--epochs", "2", "--checkpoint-dir",
                      str(tmp_path / "oracle")])
    oracle = digest(capsys.readouterr().out)
    ex.main(common + ["--epochs", "1", "--checkpoint-dir",
                      str(tmp_path / "resume")])
    capsys.readouterr()
    ex.main(common + ["--epochs", "2", "--checkpoint-dir",
                      str(tmp_path / "resume")])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out, out
    assert digest(out) == oracle
