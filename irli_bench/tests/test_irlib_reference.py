"""The plain reference held to the port's CPU path at tiny sizes, on the
inputs the harness makes: a frozen index's ids, scores and n_candidates
(both metrics, every mode) and each row the server serves."""
import numpy as np
import pytest
import torch

import tiny
from irli_bench import data, system
from irli_bench.reference import search as ref

SEED = 2**31 + 17


def inputs_of(name: str):
    c = tiny.cell(name)
    return c, data.make_inputs(c["config"], SEED, "cpu")


def assert_same(got, want):
    ids, scores, n = (torch.as_tensor(np.asarray(t)) for t in got)
    assert torch.equal(ids.to(torch.int32), want[0].to(torch.int32))
    assert torch.equal(n.to(torch.int64), want[2].to(torch.int64))
    ok = want[0] >= 0
    assert torch.allclose(scores[ok], want[1][ok], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["deep1b-batch", "sift1m-batch"])
@pytest.mark.parametrize("mode", ["auto", "compact", "mega"])
def test_frozen_search_equals_the_port(name, mode):
    c, inputs = inputs_of(name)
    cfg = c["config"]
    idx, store = system.frozen_index(cfg, inputs, "cpu")
    q = data.query_batch(cfg, inputs, SEED, "window", 0, 200)
    res = idx.search(q, store, system.search_params(cfg, mode=mode))
    want = ref.search(ref.build(inputs, cfg), q, **cfg["search"])
    assert_same((res.ids, res.scores, res.n_candidates), want)
    assert int(want[2].sum()) > 0


def test_each_served_row_equals_the_reference():
    from repro_torch.serve.server import IRLIServer
    c, inputs = inputs_of("deep1b-served")
    cfg, mix = c["config"], c["traffic"]
    idx, store = system.frozen_index(cfg, inputs, "cpu")
    params = system.search_params(cfg)
    q = data.query_batch(cfg, inputs, SEED, "served", 0, 24).numpy()
    server = IRLIServer(idx, params=params, base=store,
                        max_batch=mix["max_batch"], max_wait_ms=1.0,
                        probe_stats=True)
    try:
        futs = [server.submit(row, params) for row in q]
        got = [f.result(timeout=120) for f in futs]
    finally:
        server.close()
    index = ref.build(inputs, cfg)
    for i, r in enumerate(got):
        want = ref.search(index, torch.as_tensor(q[i:i + 1]),
                          **cfg["search"])
        assert_same((r.ids[None], r.scores[None], [r.n_candidates]), want)


def test_control_rounds_to_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.3])
    y = ref.to_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0           # a tie to even
    assert y[2] == 1.0 + 2**-10 + 2**-10 or y[2] == 1.0 + 2**-10
    assert (y.view(torch.int32) & 0x1FFF == 0).all()
