"""Multi-pod dry run: each (architecture x input shape) cell's step traced
for rank 0 of a production mesh, with its memory, work and collectives
recorded. Port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single \\
        --arch irli-deep1b
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi \\
        --arch gemma-7b --shape train_4k

The reference lowers and compiles every cell on 512 fake host devices and
reads XLA's per-device analysis. Here one process is rank 0 of torch's
``fake`` process group (256 ranks on the single mesh, 512 on the multi;
collectives return at once), the mesh is ``launch/mesh.
make_production_mesh``, and the step runs once under ``FakeTensorMode``
on fake ``cuda`` tensors, so that the traced program is the card's (the
kernels' fake paths, ``kernels.billing``), on a machine without a card
too. Where torch is built without CUDA (no device guard and no
accelerator for a fake ``cuda`` tensor's indexing and backward), the fake
tensors are the meta device's and stand for the card's
(``kernels.stand_in_card``): the same program; the host's own tensors
(the optimizer's step counter, DTensor's planning) stay on the CPU. Params, optimizer state and inputs are rank 0's
local shards (DTensors from fake local tensors; serve_query's shard
axis dropped, as its step built on the mesh takes it), and
``analysis/cost.CostRecorder``
records the call: the counterpart of XLA's per-device memory and cost
analysis, with host reads that a tensor without data cannot answer given
:data:`ANSWERS`.

Results are cached incrementally in ``artifacts/torch_dryrun_<mesh>.json``
(``--force`` re-runs the selected cells); statuses ok, skip and error, and
the exit code is 1 on any error. Every unskipped registry cell's step
runs on a mesh: the LM train, prefill and decode cells, the paper's own
production cells, the CTR models' and SchNet's (a cell the registry
lacks is recorded as an error). Each record also carries
``replication`` (:func:`record_cell`): its FLOPs x world size over those
of the same step on the whole arguments on one device.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts")

#: host reads a fake tensor cannot answer, by site, and the answer: a
#: stable top-k's tie test (the untied path, the common one on the card);
#: the sharded search's shard-size check (every shard of a cell's corpus
#: has the same size, by its params' construction)
ANSWERS = {"core/topk.py:topk_stable": False,
           "core/distributed.py:_ShardSizeCheck.__call__": True}

WORLD = {"single": 256, "multi": 512}

#: the fake tensors' device: the card's where torch is built with CUDA;
#: else the meta device, whose tensors stand for the card's
#: (``kernels.stand_in_card``): the same program, ops and collectives.
#: The mesh is the card's either way.
DEVICE = "cuda" if torch.backends.cuda.is_built() else "meta"


def fake_world(world_size: int) -> None:
    """This process as rank 0 of torch's ``fake`` process group of
    ``world_size`` ranks (any default group before is destroyed)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _local_shape(shape, spec, mesh) -> tuple:
    """Rank 0's block of a global ``shape`` under ``spec``."""
    from repro_torch.models.module import local_block, placements
    return tuple(local_block(shape, mesh, placements(spec, mesh))[0])


def fake_dtensor(meta, spec, mesh):
    """Rank 0's DTensor of a global ``meta`` (anything with shape and
    dtype) under ``spec``, its local shard a fake tensor on
    :data:`DEVICE` (call under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.module import placements
    shape = tuple(meta.shape)
    local = torch.empty(_local_shape(shape, spec, mesh), dtype=meta.dtype,
                        device=DEVICE)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=shape, stride=stride)


def fake_shard(meta, spec, mesh):
    """Rank 0's plain local tensor of a global ``meta`` under ``spec``: a
    leading axis split over every mesh axis (the serve_query cell's shard
    axis, which its step built on the mesh takes as a plain tensor) is
    dropped; a replicated leaf is whole. Only for such a step: any other
    step takes DTensors (:func:`fake_dtensor`), and a table split on its
    rows over every axis would lose its rows here."""
    shape = _local_shape(meta.shape, spec, mesh)
    if spec and spec[0] is not None and len(
            (spec[0],) if isinstance(spec[0], str) else spec[0]) == len(
                mesh.mesh_dim_names):
        shape = shape[1:]
    return torch.empty(shape, dtype=meta.dtype, device=DEVICE)


def fake_like(tree):
    """The same nesting (dicts, lists, tuples) with each card tensor
    replaced by a fake one of its shape, strides and dtype on
    :data:`DEVICE` (call under ``FakeTensorMode``) and each host tensor
    by a real copy (the optimizer's step counter stays the host's): the
    arguments of a real call, for its dry run."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    if isinstance(tree, dict):
        return {k: fake_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fake_like(v) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return tree
    if tree.device.type == "cpu":
        with unset_fake_temporarily():
            return tree.clone()
    return torch.empty_strided(tuple(tree.shape), tree.stride(),
                               dtype=tree.dtype, device=DEVICE)


def _tree(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _tree(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):                  # the LM's per-layer caches
        return [_tree(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def lower_cell(arch, shape: str, mesh):
    """The counterpart of the reference's ``lower_cell`` for an ArchDef:
    the cell's step (built on the host), a function that makes rank 0's
    arguments as fake tensors (call it under ``FakeTensorMode``) and a
    dict in which that call leaves ``"want"``, the bytes of those local
    shards by the specs' arithmetic (params by ``rules()`` or the cell's
    ``param_specs``, the optimizer state by ``opt_state_specs``, the
    batch by ``in_specs``), and ``"whole"``, a function that makes the
    cell's whole arguments as plain fake tensors (:func:`_global_args`)
    -> (step, make_args, box), or None for a skipped cell."""
    cell = arch.cells[shape]
    if cell.skip:
        return None
    params_meta = cell.params(mesh) if cell.params else \
        arch.abstract_params()
    pspecs = (cell.param_specs(mesh, params_meta)
              if cell.param_specs is not None
              else arch.rules().specs(params_meta))
    inputs_meta = cell.inputs(mesh)
    in_specs = cell.in_specs(mesh)
    step = cell.step(mesh) if cell.step_with_mesh else cell.step()
    box: dict = {}

    def make_args():
        args, box["want"] = _fake_args(arch, cell, mesh, params_meta, pspecs,
                                       inputs_meta, in_specs)
        return args

    box["whole"] = lambda: _global_args(arch, cell, params_meta, inputs_meta)
    return step, make_args, box


def _spec_bytes(tree, specs, mesh) -> int:
    """Bytes of rank 0's blocks of a tree of global shapes under a spec
    tree (the serve cell's dropped shard axis is a size-1 dim)."""
    if isinstance(tree, dict):
        return sum(_spec_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, list):
        return sum(_spec_bytes(v, s, mesh) for v, s in zip(tree, specs))
    return math.prod(_local_shape(tree.shape, specs, mesh)) \
        * tree.dtype.itemsize


def _fake_args(arch, cell, mesh, params_meta, pspecs, inputs_meta,
               in_specs) -> tuple:
    """-> (rank 0's fake arguments, their bytes by the specs)."""
    from repro_torch.launch.steps import opt_state_specs
    want = (_spec_bytes(params_meta, pspecs, mesh)
            + _spec_bytes(inputs_meta, in_specs, mesh))
    if cell.kind != "train":
        # a serve step built on the mesh (serve_query's sharded search)
        # takes its shards as plain tensors; any other takes DTensors
        fake = ((lambda m, s: fake_shard(m, s, mesh)) if cell.step_with_mesh
                else (lambda m, s: fake_dtensor(m, s, mesh)))
        return (_tree(fake, params_meta, pspecs),
                _tree(fake, inputs_meta, in_specs)), want
    params = _tree(lambda m, s: fake_dtensor(m, s, mesh), params_meta,
                   pspecs)
    opt_whole = _global_args(arch, cell, params_meta, {})[0]["opt"]
    ospecs = opt_state_specs(arch.opt, params_meta, pspecs, mesh)
    opt_state = {k: _tree(lambda m, s: fake_dtensor(m, s, mesh), v,
                          ospecs[k])
                 for k, v in opt_whole.items() if k != "step"}
    want += sum(_spec_bytes(opt_whole[k], ospecs[k], mesh)
                for k in opt_state)
    opt_state["step"] = opt_whole["step"]           # the host counter
    want += 4
    batch = _tree(lambda m, s: fake_dtensor(m, s, mesh), inputs_meta,
                  in_specs)
    return ({"params": params, "opt": opt_state}, batch), want


def _global_args(arch, cell, params_meta, inputs_meta) -> tuple:
    """The cell's arguments whole, as plain fake tensors on :data:`DEVICE`
    (call under ``FakeTensorMode``): the step's input on one device with
    no mesh, for :func:`record_cell`'s ``replication``."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    from repro_torch.launch.steps import make_opt

    def whole(tree):
        if isinstance(tree, dict):
            return {k: whole(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [whole(v) for v in tree]
        return torch.empty(tuple(tree.shape), dtype=tree.dtype,
                           device=DEVICE)

    params, batch = whole(params_meta), whole(inputs_meta)
    if cell.kind != "train":
        return params, batch
    opt_state = {k: v for k, v in make_opt(arch.opt, **arch.opt_kw).init(
        params).items() if k != "step"}
    with unset_fake_temporarily():        # the host counter: real, step 0
        opt_state["step"] = torch.zeros((), dtype=torch.int32)
    return {"params": params, "opt": opt_state}, batch


def dry_record(step, make_args, *, answers=None) -> dict:
    """``step(*make_args())`` traced once: the arguments made as fake
    tensors on :data:`DEVICE` under a ``FakeTensorMode``, the call run in
    it (the kernels' fake paths on the card's branch) under the cost
    recorder -> the record (``analysis/cost.py``'s keys; ``trace_s``, the
    call's seconds). ``answers``: the host reads' answers (default
    :data:`ANSWERS`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.cost import analyze_call
    from repro_torch.kernels import stand_in_card
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    with fake_mode:
        args = make_args()
    with fake_mode, stand_in_card():
        rec, _ = analyze_call(step, args, device=DEVICE, dry=True,
                              answers=ANSWERS if answers is None
                              else answers)
    rec["trace_s"] = round(rec.pop("seconds"), 2)
    return rec


def record_cell(arch, shape: str, mesh) -> dict:
    """One cell of an ArchDef on ``mesh`` (inside a fake world) -> its
    record ({"status": "skip", "reason"} for a skipped cell), with the
    mesh's size and axes and ``argument_bytes_by_specs`` (raises unless
    the recorded argument bytes equal it); an LM train cell also carries
    ``model_flops``
    (model_flops_per_token x global tokens) and ``flops_ratio`` (flops x
    world size / model_flops: at least 1 when every model FLOP is done on
    some rank).

    ``replication``: flops x world size / the FLOPs of the same step on
    the cell's whole arguments on one fake device with no mesh
    (``global_flops``, traced too): how many ranks do each FLOP, 1 when
    the work is split and the world size when every rank does all of it.
    A cell whose step is built on the mesh (the LM train cells, which
    carry ``flops_ratio``, and serve_query's sharded search) has no
    meshless step: its ``replication`` is None."""
    t0 = time.perf_counter()
    low = lower_cell(arch, shape, mesh)
    if low is None:
        return {"status": "skip", "reason": arch.cells[shape].skip}
    step, make_args, box = low
    rec = dry_record(step, make_args)
    rec["argument_bytes_by_specs"] = box["want"]
    if rec["argument_bytes"] != box["want"]:
        raise AssertionError(
            f"argument bytes {rec['argument_bytes']} recorded, "
            f"{box['want']} by the specs")
    world = math.prod(mesh.mesh.shape)
    rec["world_size"] = world
    rec["replication"] = rec["global_flops"] = None
    if not arch.cells[shape].step_with_mesh:
        whole = dry_record(step, box["whole"])
        rec["global_flops"] = whole["flops"]
        rec["replication"] = rec["flops"] * world / max(whole["flops"], 1)
        rec["trace_s"] = round(rec["trace_s"] + whole["trace_s"], 2)
    rec["mesh"] = dict(zip(mesh.mesh_dim_names,
                           (int(s) for s in mesh.mesh.shape)))
    if arch.family == "lm" and arch.cells[shape].kind == "train":
        from repro_torch.configs.lm_common import SHAPES
        sh = SHAPES[shape]
        rec["model_flops"] = arch.model_flops_per_token * sh["batch"] \
            * sh["seq"]
        rec["flops_ratio"] = rec["flops"] * world / rec["model_flops"]
    rec["status"] = "ok"
    rec["lower_s"] = round(time.perf_counter() - t0 - rec["trace_s"], 2)
    return rec


def check_store_accounting(rec: dict, n_shards: int) -> dict:
    """Per-shard byte accounting for irli-deep1b/serve_query: the cell's
    arguments must carry int8 CODE bytes, not fp32 vectors.

    Returns the accounting dict (also stashed on the record); raises when
    the int8 payload is not >= 3x smaller than fp32 (config arithmetic),
    or when the record's ``argument_bytes`` exceed the global int8-store
    budget, n_shards x (int8 store + members) plus 4 GiB of slack for the
    replicated scorer, the queries and alignment: a fp32 base would pass
    it by about n_shards x (fp32 - int8) bytes. The record is rank 0's
    (per device), which the bound brackets as the reference's does."""
    from repro_torch.configs.irli_deep1b import serve_store_bytes
    acct = serve_store_bytes(n_shards)
    ratio = acct["fp32_per_shard"] / acct["int8_per_shard"]
    if ratio < 3.0:
        raise AssertionError(
            f"store accounting: int8 payload only {ratio:.2f}x smaller "
            "than fp32 — the serve cell is not declaring code bytes")
    args = rec.get("argument_bytes")
    if args is not None:
        slack = 4 << 30
        budget = n_shards * (acct["int8_per_shard"]
                             + acct["members_per_shard"]) + slack
        if args > budget:
            raise AssertionError(
                f"store accounting: argument bytes {args} exceed the "
                f"int8-store budget {budget} — fp32 vectors are back in the "
                "serve arguments")
    rec["store_accounting"] = dict(acct, fp32_over_int8=round(ratio, 2))
    return acct


def run_cell(arch_name: str, shape: str, mesh) -> dict:
    """One registry cell on ``mesh`` (inside the fake world) -> its record
    (:func:`record_cell`); serve_query's also passes
    :func:`check_store_accounting` with the mesh's size. A shape the
    arch lacks raises KeyError."""
    from repro_torch.configs.registry import get_arch
    arch = get_arch(arch_name)
    rec = record_cell(arch, shape, mesh)
    if rec["status"] == "ok" and arch_name == "irli-deep1b" \
            and shape == "serve_query":
        check_store_accounting(rec, rec["world_size"])
    return rec


def main(argv=None) -> int:
    from repro_torch.configs.registry import ARCHS, get_arch
    from repro_torch.launch.mesh import make_production_mesh
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    out_path = args.out or os.path.join(ART,
                                        f"torch_dryrun_{args.mesh}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    results = {}
    if os.path.exists(out_path):   # --force re-runs selected cells but never
        with open(out_path) as f:  # discards other cells' cached results
            results = json.load(f)

    fake_world(WORLD[args.mesh])
    mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                device_type="cuda")
    print(f"mesh: {tuple(mesh.mesh.shape)} axes={mesh.mesh_dim_names} "
          f"ranks={WORLD[args.mesh]} (fake process group, rank 0)",
          flush=True)

    cells = []
    for name in ([args.arch] if args.arch else list(ARCHS)):
        for shape in ([args.shape] if args.shape
                      else list(get_arch(name).cells)):
            cells.append((name, shape))

    for name, shape in cells:
        key = f"{name}/{shape}"
        if key in results and results[key].get("status") in ("ok", "skip") \
                and not args.force:
            print(f"[cache] {key}: {results[key]['status']}", flush=True)
            continue
        print(f"[trace] {key} ...", flush=True)
        try:
            rec = run_cell(name, shape, mesh)
            results[key] = rec
            if rec["status"] == "skip":
                print(f"[skip]  {key}: {rec['reason']}", flush=True)
            else:
                print(f"[ok]    {key}: trace={rec['trace_s']}s "
                      f"flops={rec['flops']:.4g} "
                      f"args={rec['argument_bytes'] / 2**30:.3f}GiB "
                      f"temp={rec['temp_bytes'] / 2**30:.2f}GiB "
                      f"coll={rec['collective_count']}", flush=True)
        except Exception as e:
            results[key] = {"status": "error",
                            "error": f"{type(e).__name__}: {e}",
                            "trace": traceback.format_exc()[-2000:]}
            print(f"[FAIL]  {key}: {type(e).__name__}: {e}", flush=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)

    n_ok = sum(1 for v in results.values() if v["status"] == "ok")
    n_skip = sum(1 for v in results.values() if v["status"] == "skip")
    n_err = sum(1 for v in results.values() if v["status"] == "error")
    print(f"done: {n_ok} ok / {n_skip} skip / {n_err} error -> {out_path}",
          flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
