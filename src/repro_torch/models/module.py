"""Parameter-tree helpers of the model families (LM, recsys).

Port of ``repro/models/module.py``. The reference keeps params as nested
dicts of arrays; the port keeps the same nesting as
``nn.ParameterDict`` (a dict of tensors) inside ``nn.ModuleDict`` /
``nn.ModuleList`` (:func:`as_module`), so ``p["q_proj"]["kernel"]`` reads
as in the reference and the parameter names follow its paths
(``layers.0.attn.q_proj.kernel``).

``ShardRules`` (reference ``:46-88``) maps "a/b/c" paths to a
per-dimension spec: a tuple whose entries are an axis name, a tuple of
axis names or None, where the reference has a ``PartitionSpec`` (``()``
replicates, as ``P()`` does).

Two placements on a ``torch.distributed`` DeviceMesh exist side by side:

  * the fit engine and the Trainer keep plain local tensors, each rank its
    contiguous block of a dimension (``train/elastic.reshard_tree``, the
    layout of the fit engine's ``shard_state``);
  * the LM's train step on a mesh (``launch/steps.build_lm_train_step(
    mesh=)``) takes DTensors: ``placements`` turns a spec into DTensor
    placements (``Shard(dim)`` on each mesh dimension the spec names for
    ``dim``, ``Replicate()`` on the others), ``place`` and ``place_tree``
    make this rank's DTensor of a whole tensor or tree, and ``on_whole``
    runs plain code on the whole tensors of replicated DTensors (the
    sites DTensor cannot carry). The CTR and GNN steps take DTensors too,
    but run their models on each rank's own rows (``on_batch_rows``):
    the batch's local blocks, the replicated params' local tensors
    (``local_param``: a gradient partial over the rows' axes), and the
    tables split on their rows read through ``models/embedding``, which
    gathers the ids by the batch's layout (``batch_rows``).

``constrain`` and ``constrain_first`` are not ported: the port's mesh code
places every tensor itself, and without a mesh they are no-ops in the
reference too.
"""
from __future__ import annotations

import contextvars
import re
from typing import Any, Callable, Sequence

import torch
from torch import nn

from repro_torch.checkpoint.checkpointer import flatten_with_paths

__all__ = ["ShardRules", "Spec", "as_module", "batch_rows", "cast_floating",
           "data_axes", "device_of", "grad_asked", "is_dtensor",
           "is_row_sharded", "layer_list", "local_param", "local_params",
           "on_batch_rows",
           "on_whole", "pin_batch", "place", "place_tree", "placements",
           "reduce_over", "rows_dtensor", "rows_partial", "sum_over_rows",
           "replicated_like", "tensor_tree", "tree_to",
           "flatten_with_paths", "map_with_paths", "mesh_sizes",
           "param_bytes", "param_count", "spec_axes", "tree_paths",
           "unshard_dim"]

#: a per-dimension sharding spec: entry i names the mesh axis (or tuple of
#: axes) dimension i is split over, None keeps it whole; () replicates
Spec = tuple


def as_module(tree: Any) -> nn.Module:
    """A nested dict (or list) of tensors -> the same nesting as modules: a
    dict of tensors becomes an ``nn.ParameterDict``, a dict of dicts an
    ``nn.ModuleDict``, a list an ``nn.ModuleList``. The tensors become
    parameters that require no gradient: a train step asks for one only
    for its own call (``launch/steps.grads_of``)."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([as_module(t) for t in tree])
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    if any(isinstance(v, torch.Tensor) for v in tree.values()):
        raise ValueError(f"a params dict mixes tensors and subtrees: "
                         f"{sorted(tree)}")
    return nn.ModuleDict({k: as_module(v) for k, v in tree.items()})


def tensor_tree(params: Any) -> Any:
    """A module (or nested dict / list) -> the same nesting as plain dicts
    of its tensors (the same storage), a list level keyed "0", "1", ...:
    the form a train step's state, its optimizer and a checkpoint take
    (``checkpoint.flatten_with_paths`` walks dicts only)."""
    if isinstance(params, torch.Tensor):
        return params
    if isinstance(params, (list, tuple, nn.ModuleList)):
        return {str(i): tensor_tree(v) for i, v in enumerate(params)}
    return {k: tensor_tree(v) for k, v in params.items()}


def tree_to(tree: Any, device) -> Any:
    """A copy of a nested dict of tensors on ``device`` (detached)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.detach().to(device, copy=True)


def layer_list(layers: Any) -> list:
    """A model's layers in order, from an ``nn.ModuleList``, a list or the
    {"0", "1", ...} dict of :func:`tensor_tree`."""
    if isinstance(layers, (dict, nn.ModuleDict)):
        return [layers[str(i)] for i in range(len(layers))]
    return list(layers)


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple, nn.ModuleList)):
        for v in tree:
            yield from _tensors(v)
    else:
        for v in tree.values():
            yield from _tensors(v)


def grad_asked(*trees: Any) -> bool:
    """Whether autograd will want a gradient through a computation on
    these tensors or parameter trees: grad mode is on and one of their
    tensors requires grad. A kernel launched through ctypes writes into a
    fresh tensor with no ``grad_fn``, so a caller that sees True must not
    launch one that has no backward."""
    if not torch.is_grad_enabled():
        return False
    return any(t.requires_grad for tree in trees for t in _tensors(tree))


def _leaves(params) -> list[torch.Tensor]:
    if isinstance(params, nn.Module):
        return list(params.parameters())
    return [v for _, v in flatten_with_paths(params)]


def device_of(params) -> torch.device:
    """The device of a module's or nested dict's first leaf."""
    return _leaves(params)[0].device


def param_count(params) -> int:
    """Elements of every leaf of a module or nested dict."""
    return sum(int(v.numel()) for v in _leaves(params))


def param_bytes(params) -> int:
    return sum(int(v.numel()) * v.element_size() for v in _leaves(params))


def cast_floating(params, dtype: torch.dtype):
    """Floating leaves cast to ``dtype``, integer leaves kept. A module is
    cast in place (``nn.Module.to`` casts only floating parameters) and
    returned; a nested dict gives a new one."""
    if isinstance(params, nn.Module):
        return params.to(dtype)
    if isinstance(params, dict):
        return {k: cast_floating(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params


# ------------------------------------------------------- paths and rules --
def tree_paths(tree: Any) -> list[str]:
    """The "a/b/c" path of every leaf of a nested dict, keys sorted."""
    return [p for p, _ in flatten_with_paths(tree)]


def map_with_paths(fn: Callable[[str, Any], Any], tree: Any,
                   prefix: str = "") -> Any:
    """The same nesting with ``fn(path, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    return fn(prefix[:-1] if prefix.endswith("/") else prefix, tree)


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh (or of a plain dict of sizes)."""
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    return {n: int(s) for n, s in zip(mesh.mesh_dim_names, mesh.mesh.shape)}


def spec_axes(part) -> tuple[str, ...]:
    """The axis names of one spec entry (a name or a tuple of names)."""
    return (part,) if isinstance(part, str) else tuple(part)


class ShardRules:
    """Ordered path-regex -> spec rules for a param tree.

    The FIRST matching rule wins. Anything unmatched is replicated (``()``);
    ``strict=True`` raises instead, so every new param family must get an
    explicit rule. A rule's spec may be given as any sequence; it is kept as
    a tuple."""

    def __init__(self, rules: Sequence[tuple[str, Sequence]],
                 strict: bool = False):
        self.rules = [(re.compile(pat), tuple(spec)) for pat, spec in rules]
        self.strict = strict

    def spec_for(self, path: str, ndim: int | None = None) -> Spec:
        for pat, spec in self.rules:
            if pat.search(path):
                return spec
        if self.strict:
            raise ValueError(f"no sharding rule matches param {path!r}")
        return ()

    def specs(self, params: Any) -> Any:
        """The spec tree of ``params`` (tensors, arrays, or anything with
        ``ndim``)."""
        return map_with_paths(
            lambda p, v: self.spec_for(p, getattr(v, "ndim", None)), params)

    def check_divisible(self, params: Any, mesh) -> list[str]:
        """The problems (empty: every spec dimension divides by the mesh
        axes it names) of ``params`` on ``mesh``."""
        problems = []
        sizes = mesh_sizes(mesh)
        for path, leaf in flatten_with_paths(params):
            for dim, part in enumerate(self.spec_for(path)):
                if part is None:
                    continue
                names = spec_axes(part)
                total = 1
                for n in names:
                    total *= sizes[n]
                if dim >= leaf.ndim or leaf.shape[dim] % total != 0:
                    problems.append(
                        f"{path}: shape {tuple(leaf.shape)} dim {dim} not "
                        f"divisible by {names}={total}")
        return problems


# --------------------------------------------------------------- DTensor --
def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``torch.distributed.tensor.DTensor`` (without
    importing ``torch.distributed`` where it is not)."""
    if not isinstance(t, torch.Tensor) or not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def replicated_like(t: torch.Tensor, ref):
    """``t`` (the same on every rank: a constant the code builds) as a
    replicated DTensor on ``ref``'s mesh when ``ref`` is a DTensor, else
    ``t``: DTensor refuses to mix its tensors with plain ones."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def unshard_dim(t, dim: int):
    """A DTensor with dimension ``dim`` gathered whole on every rank (its
    other placements kept); a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    dim %= t.ndim
    pl = [Replicate() if getattr(p, "dim", None) == dim else p
          for p in t.placements]
    return t.redistribute(t.device_mesh, pl)


def data_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a DeviceMesh: ("pod", "data") or
    ("data",), those it has."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def pin_batch(t):
    """A DTensor split over the data axes on its first dimension and
    replicated over the others (a Partial sum reduced): the reference's
    residual-stream pin (``transformer._pin_residual``). It keeps DTensor
    from choosing other layouts, reduce-scatters among them, for the
    activations; a plain tensor passes as it is."""
    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    return t.redistribute(mesh, placements((data_axes(mesh),), mesh))


def placements(spec: Spec, mesh) -> list:
    """A spec -> DTensor placements on ``mesh``: mesh dimension ``a`` gets
    ``Shard(dim)`` when the spec names ``a`` for ``dim``, ``Replicate()``
    otherwise. A dimension split over several axes is cut in the mesh's
    order (block i·nb + j at coordinates (i, j)), the order of the
    reference's ``NamedSharding`` and of ``train/elastic.shard_leaf``; an
    axis the mesh lacks is ignored, as the reference's specs on a smaller
    mesh."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = [a for a in spec_axes(part) if a in names]
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"spec {spec}: the axes of dim {dim} must "
                             f"follow the mesh's order {names}")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return out


def local_block(shape, mesh, pl) -> tuple:
    """(local shape, global offset) of this rank's block of a tensor of
    ``shape`` under placements ``pl``: host arithmetic on the mesh's rank
    table, kept out of any fake mode (the dry run's, which would turn the
    table's values into fake ones)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():
        return compute_local_shape_and_global_offset(tuple(shape), mesh, pl)


def place(t: torch.Tensor, spec: Spec, mesh):
    """This rank's DTensor of the whole tensor ``t`` (the same on every
    rank) under ``spec``: its block is cut locally (no collective), and a
    dimension whole on this rank keeps ``t``'s storage."""
    from torch.distributed.tensor import DTensor
    pl = placements(spec, mesh)
    shape, offset = local_block(t.shape, mesh, pl)
    local = t
    for dim, (n, at) in enumerate(zip(shape, offset)):
        if n != t.shape[dim]:
            local = local.narrow(dim, at, n)
    if local is not t:
        local = local.contiguous()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def place_tree(tree: Any, specs: Any, mesh) -> Any:
    """``place`` over a nested dict (or list: the LM's per-layer caches) of
    whole tensors and its spec tree (the same nesting); a spec of None
    leaves its leaf as it is (a host counter)."""
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place_tree(v, s, mesh) for v, s in zip(tree, specs)]
    return tree if specs is None else place(tree, specs, mesh)


def on_whole(fn: Callable, *args):
    """``fn`` on the whole tensors of its DTensor arguments, each
    redistributed to ``Replicate()`` so that every rank computes the same,
    its tensor outputs (one, or a tuple) returned as replicated DTensors on
    the same mesh; other arguments and outputs pass through. It is what
    ``torch.distributed.tensor.experimental.local_map`` does with
    replicated placements, written with ``to_local`` / ``from_local`` so
    that the outputs need no declared placements; both are
    differentiable, a replicated input's gradient the local one. Without
    a DTensor argument it is ``fn(*args)``."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate
    rep = [Replicate()] * mesh.ndim
    out = fn(*[a.redistribute(mesh, rep).to_local() if is_dtensor(a)
               else a for a in args])

    def wrap(o):
        if isinstance(o, torch.Tensor):
            return DTensor.from_local(o, mesh, rep, run_check=False)
        return o

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def on_rows(fn: Callable, *args):
    """``fn`` on each data rank's own rows: its DTensor arguments, whose
    first dimension is the batch, redistributed to that dimension split
    over the data axes and whole over the others (``pin_batch``'s
    layout), ``fn`` called on their local blocks, and its tensor outputs
    (one, or a tuple; each with the batch as its first dimension) returned
    as DTensors in the same layout. For row-local work (each row routed
    and dispatched on its own), no rank holds another data rank's rows.
    Without a DTensor argument it is ``fn(*args)``."""
    ref = next((a for a in args if is_dtensor(a)), None)
    if ref is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor
    mesh, rows = ref.device_mesh, ref.shape[0]
    pl = placements((data_axes(mesh),), mesh)
    out = fn(*[a.redistribute(mesh, pl).to_local() if is_dtensor(a)
               else a for a in args])

    def wrap(o):
        if not isinstance(o, torch.Tensor):
            return o
        shape = (rows, *o.shape[1:])
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(o, mesh, pl, run_check=False, shape=shape,
                                  stride=stride)

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


#: the layout of the batch whose rows the code inside :func:`on_batch_rows`
#: runs on: (mesh, the rows' placements, the global row count)
_ROWS: contextvars.ContextVar = contextvars.ContextVar("rows", default=None)


def batch_rows() -> tuple:
    """(mesh, placements, global rows) of the batch whose local rows the
    code runs on, inside :func:`on_batch_rows` (a row-sharded table's
    lookup, ``models/embedding``, gathers its ids by it); raises
    outside."""
    rows = _ROWS.get()
    if rows is None:
        raise RuntimeError("a row-sharded table is read outside "
                           "on_batch_rows: the batch's layout is unknown")
    return rows


def is_row_sharded(t) -> bool:
    """Whether ``t`` is a DTensor split on its first dimension over some
    mesh axis (an embedding table split on its rows)."""
    return is_dtensor(t) and any(getattr(p, "dim", None) == 0
                                 for p in t.placements)


def rows_partial(rows_pl) -> list:
    """Placements partial over the mesh axes a batch's rows are split on
    (``rows_pl``: ``Shard(0)`` there) and replicated over the others: the
    layout of a sum each rank takes over its own rows."""
    from torch.distributed.tensor import Partial, Replicate
    return [Partial() if getattr(r, "dim", None) == 0 else Replicate()
            for r in rows_pl]


def local_param(p, rows_pl):
    """A replicated DTensor param as its local tensor, for code that runs
    on this rank's rows of a batch laid out by ``rows_pl``: its gradient is
    partial over the mesh axes the rows are split on (each rank adds its
    rows' share) and replicated over the others (their ranks hold the same
    rows)."""
    return p.to_local(grad_placements=rows_partial(rows_pl))


def local_params(tree: Any, rows_pl) -> Any:
    """A params tree for code on this rank's rows (``rows_pl``): each
    replicated DTensor as :func:`local_param` gives it; a row-sharded one
    (a table, read on its blocks by ``models/embedding``) and a plain
    tensor as they are."""
    if isinstance(tree, dict):
        return {k: local_params(v, rows_pl) for k, v in tree.items()}
    if not is_dtensor(tree) or is_row_sharded(tree):
        return tree
    return local_param(tree, rows_pl)


def on_batch_rows(fn: Callable, params: Any, batch: dict):
    """``fn(params, batch)`` on this rank's rows of a batch of DTensors,
    each split on its first dimension as the cell's in_specs split it (the
    first DTensor leaf gives the layout): the batch's leaves as their local
    blocks, the params as :func:`local_params` gives them (the row-sharded
    ones, tables, left as DTensors for their lookups, which gather ids by
    :func:`batch_rows`) -> (fn's output, on the local rows; the layout
    (mesh, placements, global rows)). A plain batch runs ``fn`` as it
    is, with the layout None."""
    ref = next((v for v in batch.values() if is_dtensor(v)), None)
    if ref is None:
        return fn(params, batch), None
    rows = (ref.device_mesh, tuple(ref.placements), ref.shape[0])
    lb = {k: v.to_local() if is_dtensor(v) else v for k, v in batch.items()}
    token = _ROWS.set(rows)
    try:
        return fn(local_params(params, rows[1]), lb), rows
    finally:
        _ROWS.reset(token)


def rows_dtensor(t: torch.Tensor, rows: tuple):
    """Local rows ``t`` (a batch's rows first) -> the DTensor of the whole
    batch in the layout ``rows`` (:func:`batch_rows`'s triple)."""
    from torch.distributed.tensor import DTensor
    mesh, pl, n = rows
    shape = (n, *t.shape[1:])
    return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def sum_over_rows(t: torch.Tensor, mesh, rows_pl):
    """The sum over the ranks that hold different rows of a batch laid out
    by ``rows_pl`` of each one's ``t`` (a partial sum over its rows): an
    all-reduce over the axes the rows are split on, differentiable; every
    rank gets the whole sum as a plain tensor."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, rows_partial(rows_pl),
                              run_check=False).full_tensor()


def reduce_over(t: torch.Tensor, mesh, dims, op: str = "sum"):
    """A plain tensor ``t`` reduced (``op``: "sum" or "max") over the
    ranks of the mesh dimensions ``dims`` (indices): an all-reduce over
    each, one after another, every rank of them given the result as a
    plain tensor. The other mesh dimensions are left alone (their ranks
    may hold different ``t``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    rep = [Replicate()] * mesh.ndim
    for d in dims:
        pl = [Partial(op) if i == d else Replicate()
              for i in range(mesh.ndim)]
        t = DTensor.from_local(t, mesh, pl, run_check=False).redistribute(
            mesh, rep).to_local()
    return t
