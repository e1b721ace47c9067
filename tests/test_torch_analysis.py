"""repro_torch.analysis against repro.analysis, on the CPU.

  * registry parity: after both ``load_all()``s the port registers the
    reference's 18 contract ids;
  * fixture parity: every fixture the reference can build on one CPU
    device has the reference's dims (and donated args, sweep length);
  * verdict parity: both audit CLIs, each run once in a subprocess
    (the reference's with ``--json <tmp> --no-trajectory``, so it writes
    nothing in the repository), give each contract the same verdict with
    every control tripped. The one stated difference:
    ``query.mega_single_dispatch`` fails in the reference (its dispatch
    counter sees no dispatch under jax 0.9, so its control passes) and
    passes in the port, by dispatch sites; the two mesh contracts run in
    the port's spawned world of 4 gloo ranks;
  * ports of tests/test_analysis.py (DSL and registry semantics, the
    signature counter, the seeded violations through the CLI);
  * the op recorder, the dispatch-site watch, the collective record and
    the donation check on small cases, and the two port faults the
    contracts exposed (the full-width dequant on the CPU's coarse rerank,
    the fit round's state replaced rather than overwritten).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import (Contract, ContractRegistry, Fixture, audit,
                                  forbid_dims, load_all, max_dispatches,
                                  max_trace_count, require_donated)
from repro_torch.analysis import fixtures as FX
from repro_torch.analysis import recompile as RC
from repro_torch.analysis import trace as TR
from repro_torch.analysis.collectives import CollectiveRecorder
from repro_torch.analysis.contracts import on_device

REPO = Path(__file__).resolve().parents[1]
REF_IDS = [
    "distributed.local_search_compact_no_dense_table",
    "distributed.production_merge_collectives",
    "fit.round_compiles_once", "fit.round_donates_state",
    "fit.round_no_dense_affinity", "fit.sharded_round_collectives",
    "kernels.distance_topk.no_pairwise_broadcast",
    "kernels.freq_topc.no_dense_histogram",
    "kernels.irli_topk.no_onehot_select",
    "kernels.quant_rerank.coarse_dequant_bounded",
    "online.refit_round_no_dense_affinity", "online.swap_no_index_copy",
    "query.audit_oracle_off_hot_path", "query.compact_no_dense_table",
    "query.compact_streaming_no_dense_table", "query.mega_single_dispatch",
    "search.cache_compiles_once", "store.int8_no_fp32_payload",
]
#: contracts whose verdicts differ by design (see the module docstring)
DIFFERS = {"query.mega_single_dispatch"}


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src"), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _cli(module: str, *args, timeout: float = 600):
    return subprocess.Popen(
        [sys.executable, "-m", module, *args], cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def audits(tmp_path_factory):
    """Both CLIs over every contract, run side by side -> (reference
    report, port report, port stdout)."""
    tmp = tmp_path_factory.mktemp("audits")
    ref = _cli("repro.launch.audit", "--json", str(tmp / "ref.json"),
               "--no-trajectory")
    port = _cli("repro_torch.launch.audit", "--device", "cpu", "--json",
                str(tmp / "port.json"))
    pout, perr = port.communicate(timeout=600)
    rout, rerr = ref.communicate(timeout=600)
    assert port.returncode == 0, (pout[-3000:], perr[-3000:])
    # the reference exits 1: query.mega_single_dispatch fails there
    assert ref.returncode == 1, (rout[-3000:], rerr[-3000:])
    return (json.loads((tmp / "ref.json").read_text()),
            json.loads((tmp / "port.json").read_text()), pout)


# ------------------------------------------------------------- parity --
def test_registry_matches_the_reference():
    from repro.analysis import load_all as ref_load_all
    assert sorted(ref_load_all()) == REF_IDS
    assert load_all() == REF_IDS


_BUILDERS = [
    ("query_search", ("compact",)), ("query_search", ("compact", True)),
    ("query_search", ("dense",)), ("local_search_compact", ("compact",)),
    ("local_search_compact", ("dense",)), ("audit_oracle_control", ()),
    ("store_search", ("int8",)), ("store_search", ("fp32",)),
    ("mega_store_search", ()), ("mega_split_control", ()),
    ("fit_round", ()), ("fit_round_dense_control", ()),
    ("fit_round_sweep", ()), ("online_refit_round", ()),
    ("online_refit_dense_control", ()), ("online_swap_no_copy", ()),
    ("online_swap_copy_control", ()), ("pipeline_cache_sweep", ()),
    ("freq_topc_fixture", ()), ("freq_topc_fixture", (True,)),
    ("quant_rerank_fixture", ()), ("quant_rerank_fixture", (80,)),
    ("distance_topk_fixture", ()), ("distance_topk_fixture", (True,)),
    ("irli_topk_fixture", ()), ("irli_topk_fixture", (True,)),
]


@pytest.mark.parametrize("name,args", _BUILDERS,
                         ids=[f"{n}{list(a)}" for n, a in _BUILDERS])
def test_fixture_matches_the_reference(name, args):
    """The port's fixture has the reference's dims, donated args and sweep
    length (the mesh fixtures need a world: their dims are held in the
    audit world, test_mesh_contracts_in_a_world_of_four)."""
    from repro.analysis import fixtures as RFX
    want = getattr(RFX, name)(*args)
    with on_device("cpu"):
        got = getattr(FX, name)(*args)
    assert got.dims == want.dims
    assert tuple(got.donate_argnums) == tuple(want.donate_argnums)
    assert bool(got.sweep) == bool(want.sweep)
    if want.sweep:
        assert ([lbl for lbl, _ in got.sweep["variants"]]
                == [lbl for lbl, _ in want.sweep["variants"]])


@pytest.mark.parametrize("cid", REF_IDS)
def test_verdict_matches_the_reference(audits, cid):
    """The port's CPU verdict equals the reference's, every control
    tripped where the reference has a control (query.mega_single_dispatch
    the stated exception), nothing skipped."""
    ref, port, _ = audits
    r = {c["id"]: c for c in ref["contracts"]}[cid]
    p = {c["id"]: c for c in port["contracts"]}[cid]
    assert not p["skipped"] and not p["error"], p
    assert p["passed"], p
    assert (p["control_ok"] is None) == (r["control_ok"] is None), (p, r)
    assert p["control_ok"] in (None, True), p
    if cid in DIFFERS:
        assert not r["passed"] and r["control_ok"] is False
        assert "vacuous" in r["control_detail"]
    else:
        assert r["passed"] == p["passed"], (r, p)


def test_cli_report_whole(audits):
    _, port, out = audits
    assert port["n_pass"] == 18 and port["n_fail"] == 0
    assert port["n_skip"] == 0 and port["passed"]
    assert "audit: 18 passed, 0 skipped, 0 failed" in out


def test_mesh_contracts_in_a_world_of_four(audits):
    """The merge's collectives on each of 4 gloo ranks: one all-gather of
    2·Q·P·k·4 = 640 bytes and one all-reduce of Q·4 = 16 bytes (Q = 4, P =
    4, k = 5); the mesh fit round only all-reduce and all-gather."""
    _, port, _ = audits
    p = {c["id"]: c for c in port["contracts"]}
    merge = p["distributed.production_merge_collectives"]["checks"][0]
    assert merge["passed"]
    assert "'all-gather': 640" in merge["detail"]
    assert "'all-reduce': 16" in merge["detail"]
    fit = p["fit.sharded_round_collectives"]["checks"][0]
    assert fit["passed"] and "all-gather" in fit["detail"]
    assert "all-reduce" in fit["detail"]


# ------------------------------------------- ports of test_analysis.py --
def _fixture(fn=None, args=None, dims=None, **kw):
    if fn is None:
        fn = lambda x: x + 1.0
        args = (torch.zeros((3,), dtype=torch.float32),)
    return Fixture(fn=fn, args=args, dims=dims or {}, **kw)


def test_negative_check_requires_control():
    """A forbid_* contract without a control is vacuous by construction
    and is refused at declaration."""
    with pytest.raises(ValueError, match="vacuous"):
        Contract(id="t.neg", site="tests", fixture=lambda: _fixture(),
                 checks=[forbid_dims("Q", "L")])


def test_registry_rejects_id_collision_across_sites():
    reg = ContractRegistry()
    mk = lambda site: Contract(id="t.dup", site=site,
                               fixture=lambda: _fixture(),
                               checks=[max_trace_count(1)])
    reg.register(mk("site.a"))
    reg.register(mk("site.a"))          # same site: idempotent re-import
    with pytest.raises(ValueError, match="already registered"):
        reg.register(mk("site.b"))


def test_registry_unknown_id_lists_known():
    reg = ContractRegistry()
    with pytest.raises(KeyError, match="unknown contract"):
        reg.get("t.nope")


def test_vacuous_control_fails_audit():
    """A control that passes every negative check proves nothing: the
    audit fails, it does not bless the contract."""
    fx = lambda: _fixture(dims={"Q": 3, "L": 7})    # never builds [3, 7]
    c = Contract(id="t.vacuous", site="tests", fixture=fx,
                 checks=[forbid_dims("Q", "L")], control=fx)
    r = c.audit(device="cpu")
    assert r.control_ok is False
    assert not r.passed
    assert "vacuous" in r.control_detail


def test_control_trips_makes_audit_pass():
    def dense():
        f = lambda x: x[:, None].expand(3, 7) * 2.0
        return _fixture(fn=f, args=(torch.zeros((3,)),),
                        dims={"Q": 3, "L": 7})
    c = Contract(id="t.real", site="tests",
                 fixture=lambda: _fixture(dims={"Q": 3, "L": 7}),
                 checks=[forbid_dims("Q", "L")], control=dense)
    r = c.audit(device="cpu")
    assert r.passed and r.control_ok, r.to_dict()


def test_min_devices_skips_not_fails():
    c = Contract(id="t.devices", site="tests", fixture=lambda: _fixture(),
                 checks=[max_trace_count(1)], min_devices=4097)
    r = c.audit(device="cpu")
    assert r.skipped and r.passed
    assert "devices" in r.control_detail


def test_broken_fixture_is_loud_failure():
    def boom():
        raise RuntimeError("fixture exploded")
    c = Contract(id="t.broken", site="tests", fixture=boom,
                 checks=[max_trace_count(1)])
    r = c.audit(device="cpu")
    assert not r.passed and r.error and "fixture exploded" in r.error


def test_sweep_catches_dtype_drift():
    """The canonical cache-key bug of the port: an int64 assignment where
    int32 belongs runs one logical key on a second signature — the result
    is the same, the count is not."""
    counted = RC.SignatureCounter(lambda assign: assign.sum())
    a32 = torch.zeros((2, 8), dtype=torch.int32)
    rep = RC.sweep(counted, [("int32", a32), ("int64", a32.long())],
                   expected=1, counter=counted)
    assert not rep.ok and rep.extra == 1
    assert rep.first_offender() == "int64"
    assert "dtype drift" in RC.diagnose_drift(rep)


def test_sweep_ok_on_stable_keys():
    counted = RC.SignatureCounter(lambda x: x * 2.0)
    rep = RC.sweep(counted,
                   [("a", torch.ones(4)), ("b", torch.zeros(4)),
                    ("wider", torch.ones(8))],
                   expected=2, counter=counted)
    assert rep.ok and rep.traces == 2
    assert "ok" in RC.diagnose_drift(rep)


def test_signature_counter_ticks_per_signature_not_per_call():
    counted = RC.SignatureCounter(lambda x: x + 1.0)
    for _ in range(3):
        counted(torch.zeros(4))
    counted(torch.zeros(6))
    assert counted.count == 2
    # a python float and a 0-d tensor are two signatures, as the
    # reference's weak-typed scalar and a jnp scalar are two traces
    two = RC.SignatureCounter(lambda x, s: x * s)
    two(torch.ones(2), 2.0)
    two(torch.ones(2), torch.tensor(2.0))
    assert two.count == 2


def test_pipeline_cache_compiles_once_per_key():
    """The registered contract over the real PipelineCache: 4 distinct
    (params, topC, mode) keys, each swept twice, exactly 4 compiles."""
    load_all()
    r = audit("search.cache_compiles_once", device="cpu")
    assert r.passed, r.to_dict()


@pytest.mark.parametrize("seed", ["dense_table", "drop_donation",
                                  "extra_retrace", "split_dispatch"])
def test_seeded_violation_detected(seed, tmp_path):
    """`--seed-violation X` registers a deliberately broken program; the
    audit MUST exit 1 (2 would mean the analyser is blind, 0 that the
    violation was not even flagged)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.audit", "--device",
         "cpu", "--seed-violation", seed, "--json",
         str(tmp_path / "ANALYSIS.json")],
        capture_output=True, text=True, cwd=REPO, env=_env(), timeout=600)
    assert out.returncode == 1, (seed, out.returncode, out.stdout[-2000:],
                                 out.stderr[-2000:])
    assert "[FAIL] seeded." in out.stdout


# --------------------------------------------------------- the recorder --
Q_, L_ = 6, 4096


def test_expand_is_not_a_materialization():
    live = torch.ones(L_, dtype=torch.bool)
    tr = TR.record_call(lambda v: v[None, :].expand(Q_, -1), (live,))
    assert [r.op for r in tr.ops] == ["aten.unsqueeze.default",
                                      "aten.expand.default"]
    assert all(r.view for r in tr.ops)
    assert not tr.sightings((Q_, L_))
    assert TR.materializes_dims(lambda v: v[None, :].expand(Q_, -1).clone(),
                                (live,), Q_, L_)


def test_mm_is_a_materialization():
    a, b = torch.randn(Q_, 16), torch.randn(16, L_)
    assert TR.materializes_dims(lambda x, y: x @ y, (a, b), Q_, L_)
    assert TR.traced_shapes(lambda x, y: x @ y, (a, b)) == [(Q_, L_)]
    rep = TR.peak_report(lambda x, y: x @ y, a, b)
    assert rep.bytes == Q_ * L_ * 4 and rep.primitive == "aten.mm.default"
    assert rep.shape == (Q_, L_) and rep.dtype == "float32"


def test_dtype_filter():
    a, b = torch.randn(Q_, 16), torch.randn(16, L_)
    fn = lambda x, y: (x @ y).to(torch.bfloat16)
    assert TR.materializes_dims(fn, (a, b), Q_, L_, dtype=torch.bfloat16)
    assert TR.materializes_dims(fn, (a, b), Q_, L_, dtype=np.float32)
    assert not TR.materializes_dims(fn, (a, b), Q_, L_, dtype="int8")
    assert TR.dtype_name(np.float32) == TR.dtype_name(torch.float32)


def test_factories_and_in_place_ops():
    """Factories count (the kernels' output buffers on the card); an
    in-place op aliases its input."""
    def fn(c):
        hist = torch.zeros((Q_, L_))
        return hist.scatter_add_(1, c, torch.ones(c.shape))
    tr = TR.record_call(fn, (torch.zeros((Q_, 3), dtype=torch.long),))
    made = [r.op for r in tr.materialized() if r.shape == (Q_, L_)]
    assert made == ["aten.zeros.default"]
    assert [r.view for r in tr.ops if r.op.startswith("aten.scatter_add_")
            ] == [True]


def test_backward_ops_are_recorded():
    """The fit round's contract covers its backward: the mode sees the
    autograd engine's ops."""
    w = torch.randn(16, 40, requires_grad=True)
    x = torch.randn(Q_, 16)

    def step(ww):
        loss = (x @ ww).relu().sum()
        loss.backward()
        return ww.grad
    tr = TR.record_call(step, (w,))
    ops = {r.op for r in tr.ops}
    assert "aten.threshold_backward.default" in ops
    assert any(r.shape == (16, 40) and r.op == "aten.mm.default"
               for r in tr.ops)


def test_dispatch_sites_count_the_top_level_only():
    """mode="mega" on the CPU enters mega_search once (the compact plain
    sequence inside it is nested); the staged split enters three sites."""
    with on_device("cpu"):
        mega = FX.mega_store_search().trace()
        split = FX.mega_split_control().trace()
    assert mega.sites == ["mega_query.mega_search"]
    assert sorted(split.sites) == ["freq_topc.frequent_topc",
                                   "irli_topk.scorer_topk",
                                   "quant_rerank.quant_coarse_topk"]
    assert mega.kernels is None and mega.launches == {}
    assert TR.count_dispatches(lambda: None, ()) == 0
    with on_device("cpu"):
        assert not max_dispatches(1).run(FX.mega_split_control()).passed
        assert max_dispatches(1).run(FX.mega_store_search()).passed


def test_unseen_calls_a_record_without_its_lead_in_blind():
    """A profiled record that saw none of its lead-in kernels is blind
    even when every port kernel was seen: the dropped prefix may hold
    torch's own kernels of the call."""
    tr = TR.CallTrace(kernels=["mega_query_kernel"],
                      launches={"mega_query": 1}, lead_in=0)
    assert tr.unseen() == {TR.LEAD_IN_KERNEL: (TR.LEAD_IN, 0)}
    tr.lead_in = 1
    assert tr.unseen() == {}
    tr.kernels = []
    assert tr.unseen() == {"mega_query": (1, 0)}
    assert TR.CallTrace(lead_in=0).unseen() == {}      # no profiler here


def test_report_round_trips_its_kernels_and_control_checks():
    from repro_torch.analysis.contracts import CheckResult, ContractReport
    r = ContractReport(
        "t.one", "tests", True, False,
        (CheckResult("max_dispatches(1)", True, "one", kernels=("k0",)),),
        True, "control tripped", control_checks=(
            CheckResult("max_dispatches(1)", False, "three",
                        kernels=("a", "b", "c")),))
    assert ContractReport.from_dict(json.loads(json.dumps(r.to_dict()))) == r


def test_collectives_recorded_in_a_group_of_one(tmp_path):
    from torch_dist_ranks import one_rank_group
    import torch.distributed as dist
    t = torch.arange(6, dtype=torch.float32)
    with one_rank_group(tmp_path):
        with CollectiveRecorder() as rec:
            parts = [torch.empty_like(t)]
            dist.all_gather(parts, t)
            dist.all_reduce(t)
            dist.broadcast(t, 0)
    assert rec.calls == [("all_gather", 24), ("all_reduce", 24),
                         ("broadcast", 24)]
    assert [c.kind for c in rec.record] == ["all-gather", "all-reduce",
                                            "broadcast"]


def test_donation_in_place_passes_and_a_copy_fails():
    def in_place(s, g):
        s.add_(g)
        return s
    ok = Contract(id="t.donate", site="tests",
                  fixture=lambda: Fixture(in_place, (torch.zeros(8),
                                                     torch.ones(8)),
                                          donate_argnums=(0,)),
                  checks=[require_donated()]).audit(device="cpu")
    assert ok.passed and ok.control_ok, ok.to_dict()
    bad = Contract(id="t.copy", site="tests",
                   fixture=lambda: Fixture(lambda s, g: s + g,
                                           (torch.zeros(8), torch.ones(8)),
                                           donate_argnums=(0,)),
                   checks=[require_donated()]).audit(device="cpu")
    assert not bad.passed and "MISSING" in bad.checks[0].detail


# ------------------------------------------- faults the contracts found --
def test_fit_round_overwrites_its_state_in_place():
    """fit.round_donates_state: the round used to replace assign and the
    generator state (and AdamW's step) with new tensors; every leaf is now
    written in place, so a round holds no second copy of the state."""
    with on_device("cpu"):
        fx = FX.fit_round()
    from repro_torch.analysis.contracts import leaves
    before = [t.untyped_storage().data_ptr() for t in leaves(fx.args[0])]
    assign0 = fx.args[0].assign.clone()
    state, _ = fx.fn(*fx.args)
    assert state is fx.args[0]
    assert [t.untyped_storage().data_ptr() for t in leaves(state)] == before
    assert not torch.equal(state.assign, assign0)      # it did re-assign
    assert int(state.opt_state["step"]) == fx.args[1].shape[0]
    load_all()
    assert audit("fit.round_donates_state", device="cpu").passed


def test_fit_after_an_install_leaves_the_artifact_sealed():
    """The round writes assign in place, so an index that installed an
    artifact must hold its own copy of the artifact's assign: a fit after
    the install leaves the sealed artifact as it was."""
    from repro_torch.artifact import IndexArtifact
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    from repro_torch.data.synthetic import clustered_ann
    cfg = IRLIConfig(d=8, n_labels=300, n_buckets=16, n_reps=2, d_hidden=16,
                     K=4, rounds=1, epochs_per_round=1, batch_size=64,
                     affinity_chunk=100)
    data = clustered_ann(n_base=cfg.n_labels, n_queries=8, d=cfg.d,
                         k_train=5)
    idx = IRLIIndex(cfg, device="cpu")
    idx.build_index()
    art = IndexArtifact.from_index(idx, data.base, version=1)
    assign0 = art.assign.clone()
    idx.install_artifact(art)
    idx.fit(data.train_queries, data.train_gt, label_vecs=data.base)
    assert not torch.equal(idx.assign, assign0[:, :cfg.n_labels])
    assert torch.equal(art.assign, assign0)
    art.verify()


def test_coarse_rerank_dequantizes_in_chunks_bit_equal():
    """store.int8_no_fp32_payload / kernels.quant_rerank...: the CPU's
    coarse rerank used to dequantize the whole [Q, C, D]; it now takes
    chunks of k' rows a query, with the same scores bit for bit."""
    from repro_torch.kernels.quant_rerank.ref import quant_rerank_ref
    from repro_torch.store.quantized import encode
    rng = np.random.default_rng(3)
    store = encode(torch.from_numpy(rng.normal(size=(300, 32)).astype(
        np.float32)), "int8", 16)
    q = torch.from_numpy(rng.normal(size=(5, 32)).astype(np.float32))
    cid = torch.from_numpy(rng.integers(-1, 300, (5, 77)).astype(np.int32))
    cnt = torch.from_numpy(rng.integers(0, 3, (5, 77)).astype(np.float32))
    for metric in ("angular", "l2"):
        full = quant_rerank_ref(q, store.codes, store.scales, cid, cnt,
                                tau=1, k=20, metric=metric)
        for chunk in (1, 16, 76, 77, 500):
            part = quant_rerank_ref(q, store.codes, store.scales, cid, cnt,
                                    tau=1, k=20, metric=metric, chunk=chunk)
            assert torch.equal(part[0], full[0])
            assert torch.equal(part[1], full[1])
    load_all()
    assert audit("store.int8_no_fp32_payload", device="cpu").passed


# ----------------------------------------------------------- the CLI --
def test_cli_needs_a_card_unless_asked_for_the_cpu(capsys):
    from repro_torch.launch import audit as AU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AU.main(["--list"])
    assert AU.main(["--list", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.split() == REF_IDS


def test_declaring_contracts_stays_import_cheap():
    """load_all() builds no fixture and imports neither the fixtures
    module nor the JAX package."""
    code = ("import sys, repro_torch.analysis as A; A.load_all(); "
            "print('repro_torch.analysis.fixtures' in sys.modules, "
            "any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=_env(), timeout=300)
    assert out.stdout.split() == ["False", "False"], out.stderr[-2000:]


def test_full_width_fixture_replacement_keeps_the_checks():
    """chip_smoke's full-width cell swaps a contract's fixture and keeps
    its checks (dataclasses.replace over the frozen Contract)."""
    load_all()
    from repro_torch.analysis import REGISTRY
    c = REGISTRY.get("query.compact_no_dense_table")
    with on_device("cpu"):
        fx = FX.query_search("compact")
    r = dataclasses.replace(c, fixture=lambda: fx).audit(
        run_control=False, device="cpu")
    assert r.passed and r.control_ok is None
    assert [x.check for x in r.checks] == [str(k) for k in c.checks]
