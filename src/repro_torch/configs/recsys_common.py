"""The 4 recsys architectures' shared cells. Port of
``repro/configs/recsys_common.py``.

Shapes (assigned):
  train_batch    batch 65,536   (train_step)
  serve_p99      batch 512      (online inference)
  serve_bulk     batch 262,144  (offline scoring)
  retrieval_cand batch 1 x 1,048,576 candidates (padded from 1M)

``retrieval_cand`` scores one query embedding against the item-embedding
table with a dot product and a top-k (``launch/steps.
build_retrieval_serve``): the brute-force path that the IRLI index
replaces.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import CellDef, sds
from repro_torch.launch import steps as S

BATCHES = {"train_batch": 65536, "serve_p99": 512, "serve_bulk": 262144}
#: candidates of the retrieval cell: 1M padded to a power of two
N_CANDIDATES = 1_048_576
#: ids the retrieval cell returns a query
RETRIEVAL_K = 100
#: queries of the retrieval cell
RETRIEVAL_BATCH = 1


def retrieval_shapes(embed_dim: int) -> dict:
    """The retrieval cell's shapes for a tower width: query [1, d], item
    table [N_CANDIDATES, d] fp32, k."""
    return {"query": (RETRIEVAL_BATCH, embed_dim),
            "item_table": (N_CANDIDATES, embed_dim), "k": RETRIEVAL_K}


def ctr_cells(input_builder: Callable, spec_builder: Callable,
              apply_fn: Callable, opt: str = "adamw_nomaster") -> dict:
    """The train_batch / serve_p99 / serve_bulk cells from an arch's input
    builders: input_builder(batch) -> {name: meta tensor};
    spec_builder(mesh, batch) -> {name: spec}."""
    cells = {}
    for name, batch in BATCHES.items():
        kind = "train" if name == "train_batch" else "serve"
        inputs = (lambda b: lambda mesh: input_builder(b))(batch)
        specs = (lambda b: lambda mesh: spec_builder(mesh, b))(batch)
        if kind == "train":
            cells[name] = CellDef(
                kind="train", inputs=inputs, in_specs=specs,
                step=(lambda a=apply_fn, o=opt:
                      S.build_ctr_train_step(a, o)[0]))
        else:
            cells[name] = CellDef(
                kind="serve", inputs=inputs, in_specs=specs,
                step=(lambda a=apply_fn: S.build_ctr_serve(a)))
    return cells


def retrieval_cell(embed_dim: int, k: int = RETRIEVAL_K) -> CellDef:
    """batch=1 query vs the 1M-candidate item table (two-tower dot
    scoring)."""

    def params(mesh):
        return {"item_table": {"table": sds((N_CANDIDATES, embed_dim))}}

    def inputs(mesh):
        return {"query": sds((RETRIEVAL_BATCH, embed_dim))}

    def in_specs(mesh):
        return {"query": ()}

    return CellDef(
        kind="serve", inputs=inputs, in_specs=in_specs, params=params,
        step=lambda: S.build_retrieval_serve(k),
        note="item table rows sharded over full grid; brute-force baseline "
             "for the IRLI learned index (paper §5.3)")


def retrieval_table_rule():
    """The retrieval item table's rule entry, as the reference's: a
    placeholder (None) whose specs each arch's rules give per mesh."""
    return (r"item_table/table", None)
