"""Contract DSL + registry: declarative static invariants, declared beside
the entry points they govern and proven by ``python -m
repro_torch.launch.audit``. Port of ``repro/analysis/contracts.py``: the
names, signatures and semantics are the reference's; only the analysers
underneath change (``analysis/trace.py`` records one real call where the
reference traces abstractly).

A :class:`Contract` bundles:

  * a :class:`Fixture`: a LAZY builder of a concrete toy call (``fn``,
    ``args``, named dims). Contracts are declared at import time in hot
    modules (``core/query.py``, ``fit/engine.py``, ...); nothing heavy
    runs, and no profiler is imported, until the contract is audited.
    Builders put their tensors on :func:`audit_device`;
  * a list of checks from the factories below, the DSL:

      ``forbid_dims("Q", "L")``         no materialised intermediate
                                        carries ALL the named dims
      ``require_dims("Q", "k")``        some intermediate DOES (the
                                        non-vacuity sighting); with
                                        ``on_chip="kernel"`` a sighting
                                        that kernel keeps in on-chip
                                        memory on the card, where it then
                                        counts only when the kernel's
                                        launch is seen in the call
      ``max_intermediate_bytes(2**20)`` peak single intermediate
      ``max_dispatches(1)``             at most N top-level kernel dispatch
                                        sites in the call, and on the card
                                        at most N CUDA kernels
      ``require_dtype_free(np.float32, "L", "D")``
                                        no intermediate of that dtype
                                        carries the dims
      ``require_donated(argnums=(0,))`` every tensor leaf of the donated
                                        args holds, after the call, the
                                        storage of a leaf of the result
                                        (the state was overwritten in
                                        place)
      ``max_trace_count(1)``            the fixture's sweep runs on at
                                        most N distinct argument signatures
      ``allowed_collectives({"all-gather": 4096})``
                                        the call's collectives are only the
                                        named kinds, each within its bytes

  * a ``control`` fixture for NEGATIVE checks (forbid_dims,
    require_dtype_free, max_intermediate_bytes, max_dispatches): a
    deliberately violating variant on which at least one negative check
    MUST fail, or the proof is vacuous; :meth:`Contract.audit` reports
    ``control_ok=False`` (a violation) when the control passes.
    ``require_donated`` makes its own control (the same call on clones of
    the donated leaves must alias none of the originals).

The audit runs on :func:`audit_device` (``Contract.audit(device=...)``):
``cuda`` unless the caller asks for the CPU, and the world size that
``min_devices`` is held to is that of the process group the audit runs in
(1 without one). ``repro_torch.analysis.load_all()`` imports every
contract-bearing module so the CLI and tests see one registry.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Optional

import torch

from repro_torch.analysis import recompile as _recompile
from repro_torch.analysis import trace as _trace

_DEVICE = threading.local()


def audit_device() -> torch.device:
    """The device fixtures build on: the one the running audit was given
    (the CPU outside an audit)."""
    return getattr(_DEVICE, "dev", None) or torch.device("cpu")


@contextlib.contextmanager
def on_device(dev):
    """Fixtures built inside this block put their tensors on ``dev``."""
    prev = getattr(_DEVICE, "dev", None)
    _DEVICE.dev = torch.device(dev)
    try:
        yield _DEVICE.dev
    finally:
        _DEVICE.dev = prev


def world_size() -> int:
    """Ranks of the default process group, 1 without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


# ------------------------------------------------------------- fixtures ----
@dataclasses.dataclass
class Fixture:
    """One concrete toy call a contract is proven over.

    ``dims`` names the distinctive sizes (``{"Q": 6, "L": 4096}``) that
    checks reference by name: sizes chosen so that no OTHER dimension
    collides with them. ``sweep`` is only for ``max_trace_count``:
    ``dict(call=, variants=, counter=)`` per :func:`recompile.sweep`
    (``fn`` may then be None). The call is recorded once, on first use,
    and every check of the fixture reads that one record; ``profile``
    (set by ``max_dispatches``) adds the card's CUDA kernel count to it.
    """
    fn: Optional[Callable]
    args: tuple
    dims: dict = dataclasses.field(default_factory=dict)
    donate_argnums: tuple = ()
    sweep: Optional[dict] = None
    profile: bool = False
    _record: Optional[_trace.CallTrace] = dataclasses.field(
        default=None, repr=False)
    _donated: tuple = dataclasses.field(default=(), repr=False)

    def resolve(self, names):
        missing = [n for n in names if n not in self.dims]
        if missing:
            raise KeyError(
                f"fixture does not define dim(s) {missing}; has "
                f"{sorted(self.dims)}")
        return tuple(self.dims[n] for n in names)

    def trace(self) -> _trace.CallTrace:
        """The call's record (run on first use, on the audit device)."""
        if self._record is None:
            if self.fn is None:
                raise ValueError("fixture has no call to record")
            dev = audit_device()
            donated = [a for i, a in enumerate(self.args)
                       if i in self.donate_argnums]
            fn, args = self.fn, self.args

            def run(*a):
                # the donated leaves' storages right before the recorded
                # call (after the warm-up call on the card)
                self._donated = tuple(storages(donated))
                return fn(*a)
            self._record = _trace.record_call(run, args, device=dev,
                                              profile=self.profile)
        return self._record


def leaves(tree) -> list:
    """The tensor leaves of nested dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in leaves(getattr(tree, f.name))]
    return []


def storages(tree) -> list:
    """The storage address of every tensor leaf."""
    return [t.untyped_storage().data_ptr() for t in leaves(tree)]


def clone_leaves(tree):
    """``tree`` with every tensor leaf cloned (the donation control)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_leaves(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: clone_leaves(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


# ---------------------------------------------------------------- checks ----
@dataclasses.dataclass(frozen=True)
class CheckResult:
    check: str           # e.g. 'forbid_dims(Q,L)'
    passed: bool
    detail: str = ""
    held_by: str = ""    # the kernel that keeps a card-side sighting
    kernels: tuple = ()  # the CUDA kernels max_dispatches saw on the card


@dataclasses.dataclass(frozen=True)
class Check:
    """One verifiable predicate over a fixture. ``negative`` checks are the
    ones a control fixture must be able to trip."""
    kind: str
    negative: bool
    run: Callable    # Fixture -> CheckResult
    label: str

    def __str__(self):
        return self.label


def _seen(hits, limit: int = 3) -> str:
    ops = []
    for r in hits:
        s = f"{r.op} {r.dtype}{list(r.shape)}"
        if s not in ops:
            ops.append(s)
    return "; ".join(ops[:limit]) + (" ..." if len(ops) > limit else "")


def forbid_dims(*names: str, dtype=None):
    """No materialised intermediate carries ALL the named dims."""
    label = f"forbid_dims({','.join(names)}" + (
        f", dtype={_trace.dtype_name(dtype)})" if dtype is not None else ")")

    def run(fx: Fixture) -> CheckResult:
        dims = fx.resolve(names)
        hits = fx.trace().sightings(dims, dtype)
        return CheckResult(label, not hits,
                           f"dims {dict(zip(names, dims))} " + (
                               f"MATERIALIZED by {_seen(hits)}" if hits
                               else "absent"))
    return Check("forbid_dims", True, run, label)


def require_dims(*names: str, dtype=None, on_chip: str | None = None):
    """Some intermediate DOES carry the dims: the non-vacuity sighting that
    proves the record saw the interesting part of the program. On the card
    a kernel may keep that intermediate in on-chip memory (``on_chip``
    names it): the sighting is then "held on chip by <kernel>", and counts
    only when that kernel's launch is seen in the call."""
    label = f"require_dims({','.join(names)}" + (
        f", dtype={_trace.dtype_name(dtype)})" if dtype is not None else ")")

    def run(fx: Fixture) -> CheckResult:
        dims = fx.resolve(names)
        tr = fx.trace()
        hits = tr.sightings(dims, dtype)
        where = f"dims {dict(zip(names, dims))} "
        if hits:
            return CheckResult(label, True, where + f"sighted: {_seen(hits)}")
        n = tr.launches.get(on_chip, 0) if on_chip else 0
        if n and audit_device().type == "cuda":
            return CheckResult(label, True, where + (
                f"held on chip by {on_chip} ({n} launch"
                f"{'es' if n > 1 else ''} in the call)"), held_by=on_chip)
        return CheckResult(label, False, where + "NEVER SEEN (vacuous?)" + (
            f"; {on_chip} launched {n} times" if on_chip else ""))
    return Check("require_dims", False, run, label)


def max_intermediate_bytes(limit: int):
    """Largest single materialised intermediate must stay under ``limit``."""
    label = f"max_intermediate_bytes({limit})"

    def run(fx: Fixture) -> CheckResult:
        rep = fx.trace().peak()
        return CheckResult(
            label, rep.bytes <= limit,
            f"peak {rep.bytes}B {rep.dtype}{list(rep.shape)} "
            f"from {rep.primitive!r} (limit {limit}B)")
    return Check("max_intermediate_bytes", True, run, label)


def max_dispatches(limit: int):
    """At most ``limit`` top-level kernel dispatch sites in the call and,
    on the card, at most ``limit`` CUDA kernels in it: the single-launch
    proof of a fused pipeline. Negative: the control (the per-stage split
    of the same computation) must exceed the limit."""
    label = f"max_dispatches({limit})"

    def run(fx: Fixture) -> CheckResult:
        if not fx.profile:                  # the count needs the profiler
            fx.profile, fx._record = True, None
        tr = fx.trace()
        n, kernels = len(tr.sites), ()
        ok = n <= limit
        detail = (f"{n} top-level dispatch site(s) "
                  f"{sorted(set(tr.sites))} (limit {limit})")
        if tr.kernels is not None:
            k, blind = len(tr.kernels), tr.unseen()
            ok = ok and k <= limit and not blind
            kernels = tuple(tr.kernels)
            detail += (f"; {k} CUDA kernel(s) "
                       f"{sorted({s[:60] for s in tr.kernels})}, "
                       f"{len(tr.copies)} memcpy/memset (lead-in kernels "
                       f"seen: {tr.lead_in} of {_trace.LEAD_IN})")
            if blind:
                detail += (f"; torch.profiler went BLIND: (launches, "
                           f"kernels seen) {blind}")
        return CheckResult(label, ok, detail, kernels=kernels)
    return Check("max_dispatches", True, run, label)


def require_dtype_free(dtype, *names: str):
    """No intermediate of ``dtype`` carries the named dims, e.g. the int8
    store never holds an fp32 tensor shaped by both L and D."""
    dt = _trace.dtype_name(dtype)
    label = f"require_dtype_free({dt}, {','.join(names)})"

    def run(fx: Fixture) -> CheckResult:
        dims = fx.resolve(names)
        hits = fx.trace().sightings(dims, dt)
        return CheckResult(label, not hits,
                           f"{dt} with dims {dict(zip(names, dims))} " + (
                               f"MATERIALIZED by {_seen(hits)}" if hits
                               else "absent"))
    return Check("require_dtype_free", True, run, label)


def require_donated(argnums: tuple = None):
    """Every tensor leaf of the donated args must hold, after the call,
    the storage of a tensor leaf of the result: the call overwrote them in
    place, as the reference's compiled module aliases every donated leaf.
    Its control is automatic: the same call on clones of those leaves must
    alias none of the originals."""
    label = f"require_donated({argnums if argnums is not None else 'fixture'})"

    def run(fx: Fixture) -> CheckResult:
        if argnums is not None and tuple(argnums) != fx.donate_argnums:
            fx.donate_argnums, fx._record = tuple(argnums), None
        if not fx.donate_argnums:
            return CheckResult(label, False,
                               "no donate_argnums on fixture or check")
        tr = fx.trace()
        out = set(storages(tr.result))
        miss = [i for i, p in enumerate(fx._donated) if p not in out]
        return CheckResult(
            label, bool(fx._donated) and not miss,
            f"{len(fx._donated) - len(miss)}/{len(fx._donated)} donated "
            f"leaves aliased by the result" + (
                f"; MISSING leaves {miss}" if miss else ""))
    return Check("require_donated", False, run, label)


def donation_control(fx: Fixture) -> tuple[bool, str]:
    """Run the fixture's call on clones of its donated leaves: the result
    must alias none of the original leaves (or the check cannot tell an
    in-place update from a copy)."""
    nums = fx.donate_argnums
    orig = set(storages([a for i, a in enumerate(fx.args) if i in nums]))
    args = tuple(clone_leaves(a) if i in nums else a
                 for i, a in enumerate(fx.args))
    res = fx.fn(*args)
    hit = orig & set(storages(res))
    if not hit:
        return True, "control (the call on cloned leaves) aliases nothing"
    return False, f"the call on cloned leaves still aliases {len(hit)} " \
        "original leaves"


def max_trace_count(expected: int):
    """The fixture's sweep must run on at most ``expected`` distinct
    argument signatures; any extra one (dtype drift, an unstable
    structure) fails."""
    label = f"max_trace_count({expected})"

    def run(fx: Fixture) -> CheckResult:
        if not fx.sweep:
            return CheckResult(label, False, "fixture has no sweep")
        rep = _recompile.sweep(fx.sweep["call"], fx.sweep["variants"],
                               expected, counter=fx.sweep.get("counter"))
        return CheckResult(label, rep.ok, _recompile.diagnose_drift(rep))
    return Check("max_trace_count", False, run, label)


def allowed_collectives(bounds: dict):
    """The call may issue ONLY the collective kinds named in ``bounds``,
    each within its byte bound (summed over the call, on this rank).
    ``{"all-gather": 4096}`` means: all-gather up to 4096 bytes,
    everything else zero. A bound may be a callable ``fixture -> int``. A
    call in which the record saw no collective at all fails: the fixture
    is a mesh program, so the record went blind."""
    label = "allowed_collectives(" + ",".join(
        f"{k}<={'fn' if callable(v) else v}"
        for k, v in sorted(bounds.items())) + ")"

    def run(fx: Fixture) -> CheckResult:
        from repro_torch.analysis.collectives import profile
        prof = profile(fx.trace().collectives)
        bad = []
        for kind, b in sorted(prof.items()):
            if b <= 0 and kind != "barrier":
                continue
            cap = bounds.get(kind)
            cap = cap(fx) if callable(cap) else cap
            if cap is None:
                bad.append(f"{kind}={b}B (not allowed)")
            elif b > cap:
                bad.append(f"{kind}={b}B > {cap}B")
        seen = {k: v for k, v in prof.items() if v}
        if not prof:
            bad.append("NO collective seen in the call (vacuous?)")
        return CheckResult(
            label, not bad,
            "; ".join(bad) if bad else
            f"collective bytes {seen!r} within bounds")
    return Check("allowed_collectives", False, run, label)


# -------------------------------------------------------------- contract ----
@dataclasses.dataclass(frozen=True)
class ContractReport:
    contract_id: str
    site: str
    passed: bool
    skipped: bool
    checks: tuple            # CheckResult...
    control_ok: Optional[bool]   # None = no control applicable
    control_detail: str = ""
    peak_bytes: int = 0
    error: str = ""
    peak: str = ""           # the peak intermediate's dtype, shape and op
    seconds: float = 0.0
    control_checks: tuple = ()   # CheckResult... of the control's run

    def to_dict(self) -> dict:
        return {
            "id": self.contract_id, "site": self.site,
            "passed": self.passed, "skipped": self.skipped,
            "checks": [dataclasses.asdict(c) for c in self.checks],
            "control_ok": self.control_ok,
            "control_detail": self.control_detail,
            "peak_bytes": self.peak_bytes,
            "error": self.error, "peak": self.peak,
            "seconds": self.seconds,
            "control_checks": [dataclasses.asdict(c)
                               for c in self.control_checks],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ContractReport":
        """Inverse of :meth:`to_dict` (a report that crossed processes)."""
        def checks(key):
            return tuple(CheckResult(**{**c, "kernels": tuple(c["kernels"])})
                         for c in d.get(key, ()))
        return cls(d["id"], d["site"], d["passed"], d["skipped"],
                   checks("checks"), d["control_ok"], d["control_detail"],
                   d["peak_bytes"], d["error"], d.get("peak", ""),
                   d.get("seconds", 0.0), checks("control_checks"))


@dataclasses.dataclass(frozen=True)
class Contract:
    """One named invariant: fixture + checks (+ control for negatives)."""
    id: str
    site: str                               # dotted path of the governed API
    fixture: Callable                       # () -> Fixture, lazy
    checks: tuple                           # Check...
    description: str = ""
    control: Optional[Callable] = None      # () -> Fixture, lazy
    min_devices: int = 1                    # skip (not fail) below this

    def __post_init__(self):
        object.__setattr__(self, "checks", tuple(self.checks))
        neg = [c for c in self.checks if c.negative]
        if neg and self.control is None:
            raise ValueError(
                f"contract {self.id!r} has negative check(s) "
                f"{[str(c) for c in neg]} but no control fixture — a "
                "negative proof without a failing positive control is "
                "vacuous")

    def audit(self, *, run_control: bool = True,
              device="cuda") -> ContractReport:
        """Prove the contract on its fixture, built on ``device`` (``cuda``
        unless the caller asks for the CPU; raises without a card); on
        negative contracts, first prove the control TRIPS at least one
        negative check."""
        from repro_torch.kernels import resolve_device
        dev = resolve_device(device)
        n_world = world_size()
        if n_world < self.min_devices:
            return ContractReport(
                self.id, self.site, passed=True, skipped=True, checks=(),
                control_ok=None,
                control_detail=(f"needs >= {self.min_devices} devices, "
                                f"have a world of {n_world}"))
        t0 = time.perf_counter()
        try:
            with on_device(dev):
                return self._audit(run_control, t0)
        except Exception as e:      # a broken fixture is a failure, loudly
            return ContractReport(
                self.id, self.site, passed=False, skipped=False, checks=(),
                control_ok=None, error=f"{type(e).__name__}: {e}",
                seconds=time.perf_counter() - t0)

    def _audit(self, run_control: bool, t0: float) -> ContractReport:
        neg = [c for c in self.checks if c.negative]
        control_ok, control_detail, tripped = None, "", ()
        if run_control and neg and self.control is not None:
            cfx = self.control()
            tripped = tuple(c.run(cfx) for c in neg)
            failing = [t for t in tripped if not t.passed]
            control_ok = bool(failing)
            control_detail = ("control tripped: " + "; ".join(
                f"{t.check}: {t.detail}" for t in failing)
                if failing else
                "CONTROL PASSED ALL NEGATIVE CHECKS — proof is vacuous")
            del cfx
        fx = self.fixture()
        results = tuple(c.run(fx) for c in self.checks)
        don = [c for c in self.checks if c.kind == "require_donated"]
        if run_control and don and control_ok is None:
            control_ok, control_detail = donation_control(fx)
        peak, where = 0, ""
        if fx.fn is not None:
            p = fx.trace().peak()
            peak, where = p.bytes, f"{p.dtype}{list(p.shape)} {p.primitive}"
        passed = all(r.passed for r in results) and control_ok is not False
        return ContractReport(
            self.id, self.site, passed=passed, skipped=False,
            checks=results, control_ok=control_ok,
            control_detail=control_detail, peak_bytes=peak, peak=where,
            seconds=time.perf_counter() - t0, control_checks=tripped)


# -------------------------------------------------------------- registry ----
class ContractRegistry:
    """Process-wide, import-time-populated, thread-safe contract store."""

    def __init__(self):
        self._lock = threading.Lock()
        self._contracts: dict[str, Contract] = {}

    def register(self, contract: Contract) -> Contract:
        with self._lock:
            prev = self._contracts.get(contract.id)
            if prev is not None and prev.site != contract.site:
                raise ValueError(
                    f"contract id {contract.id!r} already registered for "
                    f"site {prev.site!r}")
            self._contracts[contract.id] = contract
        return contract

    def get(self, contract_id: str) -> Contract:
        with self._lock:
            try:
                return self._contracts[contract_id]
            except KeyError:
                known = sorted(self._contracts)
                raise KeyError(
                    f"unknown contract {contract_id!r}; registered: "
                    f"{known}") from None

    def ids(self) -> list:
        with self._lock:
            return sorted(self._contracts)

    def audit(self, contract_id: str, **kw) -> ContractReport:
        return self.get(contract_id).audit(**kw)

    def audit_all(self, **kw) -> list:
        return [self.get(cid).audit(**kw) for cid in self.ids()]


#: the process-wide registry every declaration site writes into
REGISTRY = ContractRegistry()


def register(contract: Contract) -> Contract:
    return REGISTRY.register(contract)


def audit(contract_id: str, **kw) -> ContractReport:
    """Audit one registered contract — the call tests assert on:
    ``assert audit("query.compact_no_dense_table", device="cpu").passed``."""
    return REGISTRY.audit(contract_id, **kw)
