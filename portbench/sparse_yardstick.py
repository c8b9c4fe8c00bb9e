"""Work counts of masked attention and of expert layers, for the cells whose
attention skips keys (a window, packed documents) or whose layers route
tokens to experts.  Beside :mod:`portbench.yardstick`, which stays as it
was frozen; the peaks are its own.  Nothing here imports the program.
"""

from __future__ import annotations

from .yardstick import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def window_pairs(S: int, window=None) -> int:
    """Live (q, k) pairs of one causal sequence of ``S`` under a window
    (query ``i`` sees keys ``[i - window + 1, i]``), or causal alone."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_masked_work(BH: int, BHk: int, S: int, D: int, pairs: int) -> dict:
    """FLOP and bytes of one launch of each flash kernel over ``BH`` query
    rows and ``BHk`` kv rows of ``(S, D)`` bf16 whose masks leave ``pairs``
    live (q, k) pairs in all: 4 D FLOP a pair forward (q k^T, p v), 6 D for
    dQ, 8 D for dK and dV; each operand read once and each result written
    once, fp32 row statistics (lse, delta) 4 bytes a row."""
    q = BH * S * D * 2
    kv = BHk * S * D * 2
    row = BH * S * 4
    return {
        "flash_fwd": (4 * D * pairs, 2 * q + 2 * kv + row),
        "flash_dq": (6 * D * pairs, 3 * q + 2 * kv + 2 * row),
        "flash_dkv": (8 * D * pairs, 2 * q + 4 * kv + 2 * row),
    }


def flash_masked_bound_s(launches) -> dict:
    """The least time of one launch of each kernel, averaged over the
    step's launches: ``launches`` lists ``[BH, BHk, S, D, pairs, n]``
    (``n`` launches of that shape a step); each launch's bound is
    max(FLOP / bf16 peak, bytes / HBM peak)."""
    out = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    total = sum(n for *_, n in launches)
    for BH, BHk, S, D, pairs, n in launches:
        for k, (f, b) in flash_masked_work(BH, BHk, S, D, pairs).items():
            out[k] += n * max(f / PEAK_BF16_FLOPS, b / PEAK_HBM_BYTES)
    return {k: v / total for k, v in out.items()}


# -- the AFMoE decoder -------------------------------------------------------

def afmoe_active_params(cfg: dict) -> float:
    """Matrix parameters a token's forward multiplies through: every
    attention projection (q, k, v, the gate, o), the dense layers' SwiGLU,
    in each expert layer the router, the shared expert and the expected
    held experts a token (``top_k`` x held / published), and the untied
    head.  The embedding lookup multiplies nothing."""
    D, dh = cfg["hidden_size"], cfg["head_dim"]
    H, Hk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    L, Ld = cfg["num_hidden_layers"], cfg["num_dense_layers"]
    F = cfg["moe_intermediate_size"]
    attn = D * H * dh * 3 + 2 * D * Hk * dh
    dense = 3 * D * cfg["intermediate_size"]
    held = (cfg["num_experts_per_tok"] * cfg["num_experts"]
            / cfg["num_experts_published"])
    moe = (D * cfg["num_experts_published"]
           + 3 * D * F * (cfg["num_shared_experts"] + held))
    return (L * attn + Ld * dense + (L - Ld) * moe
            + cfg["vocab_size"] * D)


def afmoe_pairs(cfg: dict, S: int) -> list:
    """Live (q, k) pairs of one sequence in each layer."""
    W = cfg["sliding_window"]
    return [window_pairs(S, W if t == "sliding_attention" else None)
            for t in cfg["layer_types"][:cfg["num_hidden_layers"]]]


def afmoe_train_flops(cfg: dict, sequences: int, S: int) -> float:
    """Model FLOPs of one training step over ``sequences`` of ``S``: 6 x
    the active matrix parameters x tokens, plus 3 x the attention's
    forward (4 d_head FLOP a live pair a query head) in every layer.
    Recomputation is not counted."""
    heads = cfg["num_attention_heads"]
    pairs = sum(afmoe_pairs(cfg, S)) * sequences * heads
    return (6.0 * afmoe_active_params(cfg) * sequences * S
            + 3.0 * 4 * cfg["head_dim"] * pairs)


def moe_gemm_flops(assignments: float, d_model: int, d_expert: int) -> float:
    """FLOPs of the grouped expert products for ``assignments`` held
    (token, expert) pairs: three (d_model x d_expert) products forward,
    twice that backward."""
    return 3 * 3 * 2.0 * d_model * d_expert * assignments


#: Launches of each permute or combine kernel in one expert-layer call,
#: forward and backward (the combine runs again as the permute's backward).
MOE_MOVE_LAUNCHES = {"moe_permute": 1, "moe_combine": 2, "moe_combine_bwd": 1}


def moe_move_launch_bytes(tokens: float, assignments: float, d_model: int,
                          elem: int = 2) -> dict:
    """Bytes one launch of each permute or combine kernel must move for
    ``tokens`` rows of which ``assignments`` are held: the permute reads
    and writes each held row; the combine (and the permute's backward)
    reads each held row and writes each token's; the combine's backward
    reads each token's gradient once and each held output, and writes
    each held gradient."""
    row = d_model * elem
    return {"moe_permute": row * 2.0 * assignments,
            "moe_combine": row * (assignments + tokens),
            "moe_combine_bwd": row * (2.0 * assignments + tokens)}


def moe_move_bytes(tokens: float, assignments: float, d_model: int,
                   elem: int = 2) -> float:
    """Bytes the permute and combine kernels must move in one expert-layer
    call, forward and backward: ``row * (6 assignments + 3 tokens)``."""
    per = moe_move_launch_bytes(tokens, assignments, d_model, elem)
    return sum(n * per[name] for name, n in MOE_MOVE_LAUNCHES.items())


def moe_move_kernel(name: str) -> bool:
    """A permute or combine kernel of the expert layer, by its name."""
    low = name.lower()
    return "moe_permute" in low or "moe_combine" in low


def grouped_gemm_kernel(name: str) -> bool:
    """A grouped GEMM of the expert products (``torch._grouped_mm``'s
    CUTLASS kernels, templated on ``GroupProblemShape``), by its name."""
    return "groupproblemshape" in name.lower()
