"""HUGE's push/pull-hybrid communication rule applied to LM layers.

The paper's core physical-planning insight (Property 3.1 / Remark 3.1 /
Eq. 3): for each distributed join, either *push* the intermediate results
(shuffle R(q'_l), R(q'_r)) or *pull* the operand data (≤ k·|E_G|), whichever
moves fewer bytes. In an LM the same choice appears wherever a sharded
contraction pairs a large weight with routed activations:

  * MoE dispatch — push = all_to_all the routed tokens to the expert shards
    (the hash-join shuffle: tokens keyed by expert id); pull = all-gather the
    expert weights to the token shards (the PULL-EXTEND: fetch operand data,
    compute locally).
  * Vocab projection — push = shuffle per-shard logits; pull = gather the
    embedding rows of the batch's tokens.

This module is the Alg.-1-style optimiser for those joins: a byte-cost model
per communication mode, and a decision function the layers consult when
they are built. The decision is static per (arch × shape), like the paper's
plan-time physical configuration, so a step's collective schedule is fixed.

``enum_join_mode`` is the same Eq.-3 rule for the paper's native workload: a
distributed subgraph-enumeration join, where push = the PUSH-JOIN hash
shuffle of both intermediate result sets and pull = the k·|E_G|
operand-fetch bound of Remark 3.1.

Pure Python, identical to the JAX package's ``core/hybrid_comm.py``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CommDecision:
    mode: str          # "push" | "pull"
    push_bytes: float  # bytes moved per step if pushing
    pull_bytes: float  # bytes moved per step if pulling
    reason: str

    @property
    def ratio(self) -> float:
        return self.push_bytes / max(self.pull_bytes, 1.0)


def enum_join_mode(
    *,
    left_rows: float,       # |R(q'_l)| partial matches entering the join
    right_rows: float,      # |R(q'_r)|
    width_left: int,        # row width (matched vertices) per side
    width_right: int,
    graph_edges: float,     # |E_G| (undirected)
    machines: int,
    bytes_per_elem: int = 4,
) -> CommDecision:
    """Eq. 3 for a distributed subgraph-enumeration join (Property 3.1).

    push: shuffle both intermediate result sets by join key — (k−1)/k of the
          rows cross the network (the PUSH-JOIN hash shuffle).
    pull: fetch operand adjacency on demand, bounded by k·|E_G| edge records
          (Remark 3.1 — each machine pulls at most the whole data graph).

    This is the decision the optimiser's ``_comm_cost`` applies at plan time,
    exposed so a run can print the model's prediction next to the traffic it
    measured.
    """
    frac = (machines - 1) / max(1, machines)
    push = (left_rows * width_left + right_rows * width_right) * bytes_per_elem * frac
    pull = machines * graph_edges * 2 * bytes_per_elem
    mode = "push" if push <= pull else "pull"
    return CommDecision(
        mode=mode, push_bytes=push, pull_bytes=pull,
        reason=(
            f"|R_l|·w_l+|R_r|·w_r={left_rows:.3g}·{width_left}+"
            f"{right_rows:.3g}·{width_right} vs k·|E_G|={machines}·{graph_edges:.3g}"
        ),
    )


def moe_dispatch_mode(
    *,
    tokens_per_step: int,      # tokens entering this layer per optimizer step
    d_model: int,
    d_ff: int,
    num_experts: int,
    experts_per_token: int,
    dp_degree: int,            # shards the experts are spread over (EP axis)
    bytes_per_elem: int = 2,
    backward: bool = True,
) -> CommDecision:
    """Eq.-3 analogue for one MoE layer.

    push: each routed token crosses the EP axis twice (dispatch + combine),
          and the backward pass mirrors it:  4·T·topk·d_model·(dp-1)/dp bytes.
    pull: every expert's weights are gathered to all shards once per step
          (3 matrices, fwd + grad reduce):  ~4·E·d_model·d_ff·(dp-1)/dp.
    Mirrors Remark 3.1: intermediate results (routed activations) vs data
    graph (weights) — pulling the *fixed-size* weights wins exactly when the
    routed-token volume exceeds them (big training batches through small
    experts); pushing wins for tiny decode batches.
    """
    frac = (dp_degree - 1) / max(1, dp_degree)
    trips = 4 if backward else 2
    push = trips * tokens_per_step * experts_per_token * d_model * bytes_per_elem * frac
    wtrips = 4 if backward else 1
    pull = wtrips * num_experts * 3 * d_model * d_ff * bytes_per_elem * frac
    mode = "push" if push <= pull else "pull"
    return CommDecision(
        mode=mode, push_bytes=push, pull_bytes=pull,
        reason=(
            f"tokens·topk·d={tokens_per_step}·{experts_per_token}·{d_model} vs "
            f"E·3·d·ff={num_experts}·3·{d_model}·{d_ff}"
        ),
    )


def vocab_mode(
    *,
    tokens_per_step: int,
    d_model: int,
    vocab_size: int,
    tp_degree: int,
    bytes_per_elem: int = 2,
) -> CommDecision:
    """Vocab projection: push = reduce logits over the TP axis
    (T·V/tp... we count the reduce-scatter of the V-sharded logits wins:
    T·d bytes per shard boundary), pull = gather weight columns. For the big
    256k vocabs the logits dominate at prefill and the weights at decode."""
    frac = (tp_degree - 1) / max(1, tp_degree)
    push = 2 * tokens_per_step * d_model * bytes_per_elem * frac  # psum of [T, d] grads + fwd
    pull = vocab_size * d_model * bytes_per_elem * frac / max(1, tp_degree)
    mode = "push" if push <= pull else "pull"
    return CommDecision(mode=mode, push_bytes=push, pull_bytes=pull,
                        reason=f"T·d={tokens_per_step}·{d_model} vs V·d/tp")
