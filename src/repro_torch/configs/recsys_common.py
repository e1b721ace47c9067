"""The recsys cells' shared constants. Port of the constants of
``repro/configs/recsys_common.py`` (``:24``, ``:49``); the cells themselves
are ``CellDef`` mesh machinery and are not ported.

``retrieval_cand`` scores one query embedding against the item-embedding
table with a dot product and a top-k (``launch/steps.
build_retrieval_serve``): the brute-force path that the IRLI index
replaces.
"""
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
