"""The port's sharding-plan registry against the JAX package's.

The reference's registry cases (``tests/test_shardplan.py``): the six
built-in plans (names, axes, descriptions, rule names, moment tables),
``plans_for_mesh`` filtering by the mesh's axes (a real ``DeviceMesh``
in ``test_torch_gspmd.py``), plan ``tp`` equal to
``transformer_param_spec`` for ``TransformerLM``, ``Transformer`` and
``ViT``, every model of the zoo resolving every plan, unmatched leaves
raising, scalars replicating, moments resolving through their
parameter's name (``zero`` shards moments and not parameters), a moment
naming no parameter raising, ``validate``'s conflict kinds and shadowed
rules, and the ``shardplan`` CLI (its ``--lint --format json`` held to
``tests/golden/torch_shardplan_lint.json``; regenerate with ``python -m
chainermn_tpu_torch.tools.shardplan --lint --format json >
tests/golden/torch_shardplan_lint.json``).

Layout parity: for every parameter of the nine models under every plan,
the port's spec equals the reference plan's spec on the flax leaves it
comes from, mapped by ``convert.flax_spec_to_torch`` (flax leaves are
paired with port names by running the model's ``convert`` function on
arrays tagged with each leaf's index).  Under ``tp``, at 2 and 4 model
ranks, rank ``r``'s block of each sharded port weight equals the
reference's shard ``r`` moved into the port's layout (the converter run
on the tree with that shard in place of the leaf), value for value.
"""

import functools
import json
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.sharding import get_plan as ref_get_plan
from chainermn_tpu.sharding import list_plans as ref_list_plans
from chainermn_tpu.sharding import tree_path_str
from chainermn_tpu.tools import shardplan as ref_cli
from chainermn_tpu_torch import convert
from chainermn_tpu_torch.parallel.sharding import transformer_param_spec
from chainermn_tpu_torch.sharding import (
    P,
    PlanRule,
    ShardingPlan,
    get_plan,
    list_plans,
    plans_for_mesh,
    register_plan,
    validate,
)
from chainermn_tpu_torch.tools import shardplan as cli

GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_shardplan_lint.json"
MODELS = sorted(cli.MODEL_BUILDERS)
PLANS = ["dp", "dp_tp", "fsdp", "sp", "tp", "zero"]


@functools.lru_cache(maxsize=None)
def port_model(name):
    return cli.model_params(name)


@functools.lru_cache(maxsize=None)
def ref_shapes(name):
    """``{flax path: shape}`` of the reference builder's params."""
    tree = ref_cli.model_params(name)
    return {tree_path_str(p): tuple(l.shape)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _unflatten(flat):
    tree = {}
    for path, value in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


CONVERTERS = {
    "transformer_lm": convert.flax_to_state_dict,
    "transformer": convert.encdec_flax_to_state_dict,
    "vit": convert.vit_flax_to_state_dict,
    "mlp": convert.mlp_flax_to_state_dict,
    "seq2seq": convert.seq2seq_flax_to_state_dict,
}


def to_state_dict(name, flat):
    """The model's ``convert`` function on a flat ``{flax path: array}``."""
    fn = CONVERTERS.get(name)
    if fn is None:
        return convert.convnet_flax_to_state_dict(
            {"params": _unflatten(flat)})
    return fn(_unflatten(flat))


@functools.lru_cache(maxsize=None)
def origins(name):
    """``{port name: [flax paths]}``: each flax leaf's array filled with
    its index, through the converter."""
    paths = sorted(ref_shapes(name))
    tagged = {p: np.full(ref_shapes(name)[p], i, np.int64)
              for i, p in enumerate(paths)}
    sd = to_state_dict(name, tagged)
    return {k: [paths[i] for i in np.unique(v.numpy())]
            for k, v in sd.items()}


def full(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def test_registry_builtins():
    names = [p.name for p in list_plans()]
    assert names == PLANS
    with pytest.raises(KeyError, match="registered plans"):
        get_plan("nope")
    with pytest.raises(ValueError, match="already registered"):
        register_plan(get_plan("dp"))


@pytest.mark.parametrize("plan", PLANS)
def test_plan_matches_reference_names_axes_and_rules(plan):
    ours, ref = get_plan(plan), ref_get_plan(plan)
    assert (ours.name, ours.axes, ours.description) == \
        (ref.name, ref.axes, ref.description)
    assert [r.name for r in ours.rules] == [r.name for r in ref.rules]
    assert (ours.moment_rules is None) == (ref.moment_rules is None)
    if ours.moment_rules is not None:
        assert [r.name for r in ours.moment_rules] == \
            [r.name for r in ref.moment_rules]
    assert [p.name for p in ref_list_plans()] == PLANS


def _mesh(**sizes):
    """A stand-in with a ``DeviceMesh``'s ``mesh_dim_names`` and ``mesh``
    shape (the real mesh is ``test_torch_gspmd.py``'s)."""
    return types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 mesh=torch.zeros(*sizes.values()))


def test_plans_for_mesh_filters_axes_and_validates():
    both = {p.name for p in plans_for_mesh(_mesh(data=4, model=2))}
    assert both == {"dp", "dp_tp", "fsdp", "tp", "zero"}
    assert {p.name for p in plans_for_mesh(_mesh(data=4))} == {
        "dp", "fsdp", "zero"}
    # 4 heads do not divide over 3 model ranks: the head-sharding plans go
    lm = port_model("transformer_lm")
    assert {p.name for p in plans_for_mesh(_mesh(data=1, model=3), lm)} \
        == {"dp", "fsdp", "zero"}


# ---------------------------------------------------------------------------
# tp == transformer_param_spec, leaf for leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["transformer_lm", "transformer", "vit"])
def test_tp_plan_matches_transformer_param_spec(model):
    m = port_model(model)
    legacy = transformer_param_spec(m)
    assert get_plan("tp").resolve(m) == legacy
    assert any(s == P("model", None) for s in legacy.values())
    assert any(s == P(None, "model") for s in legacy.values())
    renamed = transformer_param_spec(m, model_axis="tensor")
    assert all("model" not in s for s in renamed.values())
    assert sum(s == P("tensor", None) for s in renamed.values()) == \
        sum(s == P("model", None) for s in legacy.values())


def test_param_spec_rejects_unmatched_naming():
    foreign = {"dense_a.kernel": (8, 8), "dense_b.kernel": (8, 8)}
    with pytest.raises(ValueError, match="matched NO shardable"):
        transformer_param_spec(foreign)


# ---------------------------------------------------------------------------
# Coverage and layout parity: every model x every plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("model", MODELS)
def test_every_model_resolves_every_plan(model, plan):
    m = port_model(model)
    v = validate(get_plan(plan), m)
    assert v.ok, f"{model} x {plan}: {v.render()}"
    assert v.unmatched == [] and v.n_leaves == len(list(m.parameters()))
    findings, _ = cli.lint_findings(get_plan(plan), m)
    assert findings == []


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("model", MODELS)
def test_layout_parity_with_reference(model, plan):
    """Each port parameter's spec equals the reference's on the flax
    leaves it comes from, mapped through ``convert.flax_spec_to_torch``."""
    ref_plan = ref_get_plan(plan)
    shapes = ref_shapes(model)
    ours = get_plan(plan).resolve(port_model(model))
    pairs = origins(model)
    assert set(ours) == set(pairs)
    for name, spec in ours.items():
        ndim = len(dict(port_model(model).named_parameters())[name].shape)
        mapped = {convert.flax_spec_to_torch(
            p, ref_plan.spec_for(p, shapes[p]), len(shapes[p]))
            for p in pairs[name]}
        assert mapped == {full(spec, ndim)}, (model, plan, name, mapped)


def _ref_params(model):
    if model == "transformer_lm":
        from chainermn_tpu.models.transformer import TransformerLM

        m = TransformerLM(vocab=64, d_model=32, n_heads=4, d_ff=64,
                          n_layers=2, max_len=16, dtype=jnp.float32)
        args = (jnp.ones((1, 8), jnp.int32),)
    elif model == "transformer":
        from chainermn_tpu.models.transformer import Transformer

        m = Transformer(vocab=64, d_model=32, n_heads=4, d_ff=64,
                        n_enc_layers=2, n_dec_layers=2, max_len=16,
                        dtype=jnp.float32)
        args = (jnp.ones((1, 8), jnp.int32),) * 2
    else:
        from chainermn_tpu.models.vit import ViT

        m = ViT(num_classes=10, patch=4, d_model=32, n_heads=4, d_ff=64,
                n_layers=2, dtype=jnp.float32)
        args = (jnp.ones((1, 16, 16, 3), jnp.float32),)
    kw = {"train": False} if model == "vit" else {}
    params = m.init(jax.random.PRNGKey(7), *args, **kw)["params"]
    return {tree_path_str(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(params)[0]}


def _block(a, spec, axis, n, r):
    """Shard ``r`` of ``n`` of ``a`` along every dim whose entry is
    ``axis``."""
    index = [slice(None)] * a.ndim
    for d, e in enumerate(full(spec, a.ndim)):
        if e == axis:
            k = a.shape[d] // n
            index[d] = slice(r * k, (r + 1) * k)
    return a[tuple(index)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("model", ["transformer_lm", "transformer", "vit"])
def test_tp_shards_hold_the_reference_shards(model, n):
    """Rank r's block of each ``tp``-sharded port weight equals the
    reference's shard r (heads contiguous in ``h·dh``), value for value."""
    flat = _ref_params(model)
    sd = to_state_dict(model, flat)
    ours, ref_plan = get_plan("tp").resolve(sd), ref_get_plan("tp")
    pairs = origins(model)
    n_sharded = 0
    for name, spec in ours.items():
        if "model" not in spec:
            continue
        n_sharded += 1
        (path,) = pairs[name]
        ref_spec = ref_plan.spec_for(path, flat[path].shape)
        for r in range(n):
            # the converter on the tree whose leaf is the reference's shard
            shard = _block(flat[path], ref_spec, "model", n, r)
            want = to_state_dict(model, {**flat, path: shard})[name]
            got = _block(sd[name].numpy(), spec, "model", n, r)
            np.testing.assert_array_equal(got, want.numpy(), err_msg=name)
    assert n_sharded == {"transformer_lm": 12, "transformer": 32,
                         "vit": 12}[model]


# ---------------------------------------------------------------------------
# Resolution contract
# ---------------------------------------------------------------------------


def test_resolve_raises_on_unmatched_leaf():
    plan = ShardingPlan(
        name="partial",
        rules=(PlanRule("dense", r"dense\.weight$", P("data", None)),),
        axes=("data",),
    )
    params = {"dense.weight": (8, 8), "other.weight": (8, 8)}
    with pytest.raises(ValueError, match="has no rule matching leaf"):
        plan.resolve(params)
    v = validate(plan, params)
    assert not v.ok and v.unmatched == ["other.weight"]


def test_scalars_replicate_without_a_rule():
    plan = ShardingPlan("none", rules=())
    out = plan.resolve({"w": torch.zeros(()), "step": ()})
    assert out == {"w": P(), "step": P()}
    assert get_plan("tp").resolve({"w": torch.zeros(4, 2, 8),
                                   "step": torch.zeros(())})["step"] == P()


def test_shardings_are_dtensor_placements_and_explain_rows():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh(data=2, model=2)
    got = get_plan("dp_tp").shardings(mesh, port_model("transformer_lm"))
    assert got["layers.0.attention.query.weight"] == [Replicate(), Shard(0)]
    assert got["layers.0.attention.out.weight"] == [Replicate(), Shard(1)]
    assert got["embed.weight"] == [Replicate(), Replicate()]
    both = ShardingPlan("both", (PlanRule("w", r"^w$",
                                          P(("data", "model"), None)),))
    assert both.shardings(mesh, {"w": (8, 4)})["w"] == [Shard(0), Shard(0)]
    with pytest.raises(ValueError, match="absent from the mesh"):
        get_plan("tp").shardings(_mesh(data=4), {"a.wi.weight": (8, 4)})
    rows = get_plan("tp").explain({"a.wi.weight": (8, 4), "step": ()})
    assert rows == [
        {"path": "a.wi.weight", "shape": (8, 4), "rule": "ffn_in",
         "spec": "PartitionSpec('model', None)"},
        {"path": "step", "shape": (), "rule": "<scalar>",
         "spec": "PartitionSpec()"}]


def _adam_state(module, named=False):
    params = module.named_parameters() if named else module.parameters()
    opt = torch.optim.Adam(params, lr=1e-3)
    sum(p.float().sum() for p in module.parameters()).backward()
    opt.step()
    return opt


class _Attn(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.query = torch.nn.Linear(8, 8)


@pytest.mark.parametrize("named", [False, True], ids=["by_module",
                                                      "param_names"])
def test_moment_resolution_reuses_param_rules(named):
    m = torch.nn.Module()
    m.attn = _Attn()
    opt = _adam_state(m, named)
    specs = get_plan("tp").resolve_moments(opt, None if named else m)
    assert specs["attn.query.weight"]["exp_avg"] == P("model", None)
    assert specs["attn.query.weight"]["exp_avg_sq"] == P("model", None)
    assert specs["attn.query.bias"]["exp_avg"] == P()       # 1-D: ndim gate
    assert all(s["step"] == P() for s in specs.values())


def test_zero_plan_shards_moments_not_params():
    m = torch.nn.Module()
    m.dense = torch.nn.Linear(8, 8, bias=False)
    plan = get_plan("zero")
    assert plan.resolve(m) == {"dense.weight": P()}
    specs = plan.resolve_moments(_adam_state(m), m)
    assert specs["dense.weight"]["exp_avg"] == P("data", None)


def test_moment_naming_no_parameter_is_a_hard_error():
    m = torch.nn.Linear(4, 4, bias=False)
    sd = _adam_state(m).state_dict()
    sd["state"][7] = {"exp_avg": torch.zeros(4, 4)}
    with pytest.raises(ValueError, match="entry 7 .* names no parameter"):
        get_plan("dp").resolve_moments(sd, ["weight"])
    with pytest.raises(ValueError, match="param_names"):
        get_plan("dp").resolve_moments(_adam_state(m))


# ---------------------------------------------------------------------------
# validate: every conflict kind, and a shadowed rule
# ---------------------------------------------------------------------------


def _plan(*rules):
    return ShardingPlan("t", rules=tuple(rules) + (
        PlanRule("replicate", r".*", P()),), axes=("data", "model"))


CONFLICTS = {
    "rank_overflow": (_plan(PlanRule("w", r"^w$", P("model", None, None))),
                      {"w": (8, 8)}, None, "3 entries for a rank-2 leaf"),
    "axis_twice": (_plan(PlanRule("w", r"^w$", P("model", "model"))),
                   {"w": (8, 8)}, None, "more than one entry"),
    "axis_missing": (_plan(PlanRule("w", r"^w$", P("model", None))),
                     {"w": (8, 8)}, {"data": 2}, "absent from the mesh"),
    "indivisible": (_plan(PlanRule("w", r"^w$", P(None, "model"))),
                    {"w": (8, 6)}, {"data": 1, "model": 4},
                    "dim 6 not divisible by axis size 4"),
}


@pytest.mark.parametrize("kind", sorted(CONFLICTS) + ["gqa_heads"])
def test_validate_reports_each_conflict(kind):
    if kind == "gqa_heads":
        from chainermn_tpu_torch.models.transformer import TransformerLM

        # 2 kv heads of 8 rows: the key weight's 16 rows divide by 4 model
        # ranks, but its 2 heads do not.
        with torch.device("meta"):
            lm = TransformerLM(vocab=64, d_model=32, n_heads=4, d_ff=64,
                               n_layers=1, n_kv_heads=2, device="meta")
        plan, params, mesh = get_plan("tp"), lm, {"data": 1, "model": 4}
        match = "2 heads of 8 not divisible by axis size 4"
        assert validate(plan, lm, {"data": 1, "model": 2}).ok
    else:
        plan, params, mesh, match = CONFLICTS[kind]
    v = validate(plan, params, mesh)
    assert not v.ok and v.conflicts, kind
    assert any(match in c["reason"] for c in v.conflicts), v.conflicts
    assert "conflict at" in v.render()


def test_validate_reports_a_shadowed_rule():
    plan = ShardingPlan("s", rules=(
        PlanRule("any_weight", r"weight$", P()),
        PlanRule("query", r"query\.weight$", P("model", None)),
        PlanRule("never", r"nothing$", P()),
    ))
    v = validate(plan, {"query.weight": (8, 8), "out.weight": (8, 8)})
    assert v.ok and v.shadowed == ["query"]
    assert v.summary()["shadowed"] == ["query"] and "shadowed rule" in \
        v.render()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_list_show_lint(capsys):
    r = subprocess.run([sys.executable, "-m",
                        "chainermn_tpu_torch.tools.shardplan", "--list",
                        "--format", "json"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert [p["name"] for p in json.loads(r.stdout)["plans"]] == PLANS

    assert cli.main(["--show", "mlp", "dp"]) == 0
    assert "replicate" in capsys.readouterr().out
    assert cli.main(["--show", "transformer_lm", "tp", "--format",
                     "json"]) == 0
    rows = json.loads(capsys.readouterr().out)["rows"]
    ref_rows = ref_get_plan("tp").explain(ref_cli.model_params(
        "transformer_lm"))
    # The rule names line up: as many rows of each rule as the reference.
    count = lambda rs: {r["rule"]: sum(x["rule"] == r["rule"] for x in rs)
                        for r in rs}  # noqa: E731
    assert count(rows) == count(ref_rows)
    assert cli.main(["--lint", "mlp"]) == 0
    assert "mlp×tp: clean" in capsys.readouterr().out


def test_cli_lint_json_matches_golden(capsys):
    assert cli.main(["--lint", "--format", "json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == json.loads(GOLDEN.read_text())
    assert out["ok"] and len(out["targets"]) == 9 * 6

