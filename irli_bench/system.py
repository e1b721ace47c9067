"""The system under test, built from the run's inputs through the port's
public entry points: an ``IRLIIndex`` holding the harness's scorer weights
and partition, its int8 store, and the ``SearchParams`` of the
configuration. The only module here, besides the traffic generators, that
imports the port."""
from __future__ import annotations


def index(cfg: dict, inputs: dict, device):
    """An IRLIIndex over the inputs' scorer weights and partition, its
    inverted index built."""
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    idx = IRLIIndex(IRLIConfig(d=cfg["d"], n_labels=cfg["n_labels"],
                               n_buckets=cfg["n_buckets"],
                               n_reps=cfg["n_reps"],
                               d_hidden=cfg["d_hidden"], K=cfg["K"],
                               max_load_slack=cfg["max_load_slack"]),
                    device=device)
    # a search serves without the fit's optimizer state, and with the
    # harness's weights and partition in place of the constructor's draw
    idx.opt_state = None
    idx.params = inputs["weights"]
    idx.assign = inputs["assign"]
    idx.build_index()
    return idx


def frozen_index(cfg: dict, inputs: dict, device):
    """(IRLIIndex over the inputs' weights and partition, its int8
    QuantizedStore of the corpus)."""
    from repro_torch.store.quantized import encode
    return index(cfg, inputs, device), encode(
        inputs["corpus"], cfg["store_dtype"], cfg["store_block"])


def search_params(cfg: dict, **override):
    """The configuration's SearchParams (mode "auto"), with overrides."""
    from repro_torch.core.search_api import SearchParams
    p = dict(cfg["search"], store_dtype=cfg["store_dtype"])
    p.update(override)
    return SearchParams(**p)

