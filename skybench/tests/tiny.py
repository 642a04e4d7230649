"""Cells of ``BENCHMARK.json`` shrunk to a size the CPU runs in seconds:
two layers of width 64 in f32, a 300-token vocabulary, 4 experts, short
documents and answers, pages of 32, the cell's own limits.  The tests
drive whole runs of them through the harness on the CPU."""
from __future__ import annotations

import dataclasses

from skybench import spec

TINY_MODEL = dict(num_hidden_layers=2, hidden_size=64, intermediate_size=96,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                  vocab_size=300)


def tiny_cell(workload: str) -> spec.Cell:
    cell = spec.cell(workload)
    # f32, so that a sound run's gaps are rounding only: at this width a
    # bf16 router near-tie swaps one of 2 experts and moves a logit by ~1
    c = dict(cell.config, **TINY_MODEL, torch_dtype="float32")
    if c.get("num_local_experts"):
        c.update(num_local_experts=4, num_experts_per_tok=2,
                 capacity_factor=2.0, moe_group_size=64)
    t = dict(cell.traffic, documents=4, document_tokens=96,
             question_tokens=[4, 20],
             answer_tokens={"median": 8, "sigma": 0.5, "min": 3, "max": 16})
    d = dict(cell.deploy, slots=4, max_seq_len=256, block_size=32,
             chunk_tokens=min(cell.deploy["chunk_tokens"], 128), clients=6)
    return dataclasses.replace(cell, config=c, traffic=t, deploy=d)
