"""Surface parity: every public name of the reference package has a
counterpart in the port, or is JAX-only and listed here with its reason.

Both packages are parsed with ``ast``; neither is imported.  A package's
names are its modules' public top-level functions and classes, its
classes' public methods (``Class.method``), and its lower-case public
module assignments.  A name counts as present when the port defines it
in any module (the port's layout differs where eager PyTorch needs it:
the reference's ``observability/hlo_audit.py`` is the port's
``observability/collective_audit.py`` over ``analysis/capture.py``).
A name that is not JAX-only gets ported, not listed.
"""

import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Reference names with no counterpart in the port, each with the reason.
JAX_ONLY = {
    # observability/hlo_audit.py: its HLO-text half
    "fold_async_counts": "folds XLA's async -start/-done HLO opcodes",
    "iter_eqns": "walks a jaxpr's equations",
    "audit_jaxpr": "audits a traced jaxpr",
    "audit_hlo_text": "parses compiled HLO text",
    "audit_compiled": "compiles with XLA and audits its HLO",
    "trace_step": "traces a step into a jaxpr (the port captures a run)",
    "TracedStep": "a traced jaxpr with its jit donation",
    # analysis/core.py
    "LintContext.jaxpr": "the traced jaxpr the reference's rules read",
    "analyze_jaxpr": "lints an already-traced jaxpr",
    "iter_eqns_with_path": "walks a jaxpr's equations with their path",
    # communicators: mesh axes, shard_map, multi-controller arrays
    "CommunicatorBase.axis_index": "lax.axis_index over the mesh axes",
    "CommunicatorBase.world_axes": "the mesh axis names collectives take",
    "CommunicatorBase.shard_map": "wraps a function in shard_map",
    "CommunicatorBase.ppermute": "lax.ppermute inside shard_map (the "
                                 "port: functions.send_recv)",
    "CommunicatorBase.device_for_rank": "a mesh device by rank (the port: "
                                        "one process a card, comm.device)",
    "CommunicatorBase.local_devices": "the mesh devices of this process",
    "CommunicatorBase.global_batch": "assembles a multi-controller global "
                                     "jax.Array (the port feeds per-rank "
                                     "batches)",
    "CommunicatorBase.eager_allreduce_grad": "stacked-array eager helper "
                                             "(jit of shard_map)",
    "CommunicatorBase.eager_broadcast_data": "stacked-array eager helper "
                                             "(jit of shard_map)",
    "CommunicatorBase.eager_gather": "stacked-array eager helper "
                                     "(SingleDeviceSharding)",
    "shard_map_compat": "jax's shard_map keyword shim",
    "build_mesh": "builds a jax.sharding.Mesh (the port: build_topology)",
    "axes_size": "the size of named mesh axes",
    "axis_size_traced": "lax.axis_size inside shard_map",
    "flat_rank": "traced rank from lax.axis_index",
    "ensure_overlap_flags": "XLA_FLAGS for the latency-hiding scheduler",
    # optimizers.py
    "MultiNodeOptimizerState": "the optax state pytree (the port keeps "
                               "torch.optim state)",
    "flat_shard_state_spec": "PartitionSpecs of an optax state",
    # tuning, spans, sharding, profiling
    "flash_vmem_bytes": "Pallas VMEM budget of a flash tile",
    "flash_default_config": "Pallas block_q/block_k (the port's tiles are "
                            "compiled per route)",
    "named_scope": "jax.named_scope on XLA's op metadata",
    "tree_path_str": "spells jax.tree_util key paths",
    "setup_compilation_cache": "jax's persistent compilation cache",
    "StepTimer": "a host clock times CUDA's enqueue (the port: "
                 "span(name, device=...))",
    "StepTimer.mean_s": "StepTimer's mean",
    "StepTimer.throughput": "StepTimer's rate",
}


def _names(pkg: str) -> set:
    out = set()
    root = os.path.join(REPO, pkg)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    if node.name.startswith("_"):
                        continue
                    out.add(node.name)
                    if isinstance(node, ast.ClassDef):
                        out.update(
                            f"{node.name}.{m.name}" for m in node.body
                            if isinstance(m, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))
                            and not m.name.startswith("_"))
                elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    out.update(t.id for t in targets
                               if isinstance(t, ast.Name)
                               and not t.id.startswith("_")
                               and t.id.islower())
    return out


def test_every_reference_name_has_a_counterpart_or_a_reason():
    ref, port = _names("chainermn_tpu"), _names("chainermn_tpu_torch")
    missing = ref - port
    assert sorted(missing) == sorted(JAX_ONLY), (
        "not in the port and not listed: "
        f"{sorted(missing - set(JAX_ONLY))}; listed but present or gone: "
        f"{sorted(set(JAX_ONLY) - missing)}")


def test_every_listed_name_has_a_reason():
    for name, why in JAX_ONLY.items():
        assert why and len(why) < 120 and "\n" not in why, name


def test_the_audit_is_ported():
    """Of ``hlo_audit.py`` only its HLO-text half stays JAX-only."""
    port = _names("chainermn_tpu_torch")
    for name in ("CollectiveAudit", "CollectiveAudit.census",
                 "CollectiveAudit.reduction_collectives",
                 "CollectiveAudit.summary", "audit_fn", "audit_allreduce",
                 "audit_allreduce_tree",
                 "assert_two_dimensional_inter_savings",
                 "Bucket.quantizable", "Bucket.wire_bytes",
                 "GradPacker.wire_bytes", "GradPacker.describe",
                 "GradPacker.for_tree", "wire_dtype", "fp8_supported",
                 "quantize_for_allreduce"):
        assert name in port, name
