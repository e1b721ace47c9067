"""IndexArtifact — the versioned, checksummed unit of index state.
Port of ``repro/artifact/artifact.py``.

The scorer params + assignment (the fit side), the streaming snapshot
(members / delta / tombstone / vecs) and the QuantizedStore travel as ONE
artifact, so a background refit can never pair new scorer params with an
old member matrix between fit, checkpoint and serve:

  - **immutable**: a frozen dataclass. Mutation = build a new artifact
    (``reseal`` recomputes the digest).
  - **monotonically versioned**: install sites
    (``MutableIRLIIndex.install_artifact``, ``IRLIIndex.install_artifact``)
    reject a version that does not advance the serving epoch, and
    ``SearchResult.epoch`` names the artifact version a response was
    served against.
  - **checksummed**: sha256 over every leaf's path / dtype / shape / bytes
    plus the static config, in the reference's order and spelling, so the
    same content gives the same digest in both packages (bf16 codes hash
    as ``"bfloat16"`` with their 2-byte payload). ``verify()`` recomputes;
    persistence through CheckpointManager adds the npz-level digest on top.

The swap path is a pointer flip: an artifact built from a snapshot (and
installed back) holds vecs / store / tombstone by reference, and the
swap's device work is the member rebuild (:func:`rebuild_members`), which
reads no vector payload.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import flatten_with_paths
from repro_torch.core import partition as PT
from repro_torch.kernels import resolve_device
from repro_torch.store import quantized as ST
from repro_torch.stream.delta import DeltaState, delta_init


class ArtifactIntegrityError(RuntimeError):
    """Artifact content does not match its recorded checksum."""


def rebuild_members(assign: torch.Tensor, tombstone: torch.Tensor, *,
                    B: int, max_load: int):
    """Rebuild the inverted member matrix from a full-capacity assignment:
    dead or never-issued slots (tombstoned, or holding the sentinel B) go
    to an extra bucket B, the index is built over B + 1 buckets, and the
    sentinel column is sliced off (stream/compaction's exactness trick).
    assign [R, capacity], tombstone [capacity] -> (members [R, B,
    max_load] int32, load [R, B] int32). Its inputs hold no vector
    payload."""
    masked = torch.where(tombstone[None, :],
                         torch.full((), B, dtype=assign.dtype,
                                    device=assign.device), assign)
    idx = PT.build_inverted_index(masked, B + 1, max_load)
    return (idx.members[:, :B].contiguous(),
            idx.load[:, :B].to(torch.int32).contiguous())


def _leaf_bytes(leaf) -> tuple[str, tuple, bytes]:
    """(numpy dtype name, shape, raw bytes) of a tensor or array, as the
    reference's ``np.asarray(jax.device_get(leaf))`` spells them; a bf16
    tensor is ``"bfloat16"`` with its 2-byte payload."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy(
                ).tobytes()
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return str(arr.dtype), tuple(arr.shape), arr.tobytes()


def _digest(version: int, n_total: int, meta: tuple, named_leaves) -> str:
    """sha256 over (version, n_total, static meta) + every leaf's
    path/dtype/shape/bytes, in sorted-path order."""
    h = hashlib.sha256()
    h.update(repr((int(version), int(n_total), tuple(meta))).encode())
    for path, leaf in sorted(named_leaves, key=lambda kv: kv[0]):
        dtype, shape, raw = _leaf_bytes(leaf)
        h.update(path.encode())
        h.update(dtype.encode())
        h.update(repr(shape).encode())
        h.update(raw)
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class IndexArtifact:
    """One complete, immutable index state at one version.

    Tensors:
      params     stacked R-rep scorer params
      members    [R, B, ML] inverted member matrix (pad -1)
      delta      DeltaState: [R, B, DL] append segments + fill
      tombstone  [capacity] bool
      load       [R, B] int32 live loads
      assign     [R, capacity] int32 bucket per id (B = unused slot)
      vecs       [capacity, d] fp32 vector buffer (also the refine tier)
      store      optional QuantizedStore coarse tier over the same rows
      replicas   optional [R, B, RL] int32 hot-bucket replica segments
                 (repro_torch.online.policy)
      sketch     optional [2^sketch_planes] fp32 reference query-sketch
                 histogram; meta's ``sketch_planes`` / ``sketch_seed``
                 rebuild the identical hyperplanes

    Static: version, n_total, meta (sorted (key, value) config pairs),
    checksum. Constructors here seal (compute the checksum); anything that
    transforms the tensors must ``reseal()`` before ``verify()`` passes.
    """
    version: int
    params: dict
    members: torch.Tensor
    delta: DeltaState
    tombstone: torch.Tensor
    load: torch.Tensor
    assign: torch.Tensor
    vecs: torch.Tensor
    n_total: int
    meta: tuple
    store: ST.QuantizedStore | None = None
    replicas: torch.Tensor | None = None
    sketch: torch.Tensor | None = None
    checksum: str = ""

    # ------------------------------------------------------------ identity --
    @property
    def meta_dict(self) -> dict:
        return dict(self.meta)

    def _named_leaves(self) -> list:
        out = [("params/" + p, v) for p, v in flatten_with_paths(self.params)]
        out += [("members", self.members), ("delta_members",
                self.delta.members), ("delta_fill", self.delta.fill),
                ("tombstone", self.tombstone), ("load", self.load),
                ("assign", self.assign), ("vecs", self.vecs)]
        if self.store is not None:
            out.append(("store_codes", self.store.codes))
            if self.store.scales is not None:
                out.append(("store_scales", self.store.scales))
        if self.replicas is not None:
            out.append(("replicas", self.replicas))
        if self.sketch is not None:
            out.append(("sketch", self.sketch))
        return out

    def digest(self) -> str:
        """The content digest of the current tensors."""
        return _digest(self.version, self.n_total, self.meta,
                       self._named_leaves())

    def reseal(self) -> "IndexArtifact":
        """Recompute the checksum over the current tensors."""
        return dataclasses.replace(self, checksum=self.digest())

    def verify(self) -> None:
        """Raise ArtifactIntegrityError unless content matches checksum."""
        digest = self.digest()
        if digest != self.checksum:
            raise ArtifactIntegrityError(
                f"artifact v{self.version}: content digest {digest[:12]}… "
                f"does not match recorded {self.checksum[:12] or '<unset>'}…")

    def with_version(self, version: int) -> "IndexArtifact":
        """Same content at a new version (re-sealed): versions name install
        events, content may repeat."""
        return dataclasses.replace(self, version=int(version)).reseal()

    # -------------------------------------------------------- construction --
    @classmethod
    def build(cls, *, version: int, params, members, delta, tombstone, load,
              assign, vecs, n_total: int, meta: dict,
              store=None, replicas=None, sketch=None) -> "IndexArtifact":
        """Seal a new artifact from parts (the OnlineRefitLoop's exit)."""
        art = cls(version=int(version), params=params, members=members,
                  delta=delta, tombstone=tombstone, load=load, assign=assign,
                  vecs=vecs, n_total=int(n_total),
                  meta=tuple(sorted(meta.items())), store=store,
                  replicas=replicas, sketch=sketch)
        return art.reseal()

    @classmethod
    def from_snapshot(cls, snap, cfg, *, version: int, capacity: int,
                      store_block: int = 32, n_base: int | None = None,
                      replicas=None, sketch=None, sketch_planes: int = 6,
                      sketch_seed: int = 0) -> "IndexArtifact":
        """Wrap a stream.StreamSnapshot (by reference — no copies).
        ``sketch`` freezes the fit window's query-sketch histogram (plus
        the plane-rebuilding ints) for downstream drift detection."""
        meta = {"d": int(cfg.d), "n_buckets": int(cfg.n_buckets),
                "n_reps": int(cfg.n_reps), "capacity": int(capacity),
                "loss": cfg.loss,
                "store_dtype": (snap.store.dtype if snap.store is not None
                                else "fp32"),
                "store_block": int(snap.store.block if snap.store is not None
                                   else store_block),
                "n_base": int(n_base if n_base is not None else snap.n_total)}
        if sketch is not None:
            sketch = ST.to_tensor(sketch, torch.float32, snap.members.device)
            meta["sketch_planes"] = int(sketch_planes)
            meta["sketch_seed"] = int(sketch_seed)
        return cls.build(
            version=version, params=snap.params, members=snap.members,
            delta=snap.delta, tombstone=snap.tombstone, load=snap.load,
            assign=snap.assign, vecs=snap.vecs, n_total=snap.n_total,
            meta=meta, store=snap.store,
            replicas=replicas if replicas is not None
            else getattr(snap, "replicas", None), sketch=sketch)

    @classmethod
    def from_mutable(cls, midx, *, version: int | None = None
                     ) -> "IndexArtifact":
        """Snapshot a MutableIRLIIndex as an artifact. Default version =
        the snapshot's epoch."""
        snap = midx.snapshot
        return cls.from_snapshot(
            snap, midx.cfg,
            version=snap.epoch if version is None else version,
            capacity=midx.capacity, store_block=midx.store_block,
            n_base=midx.n_base)

    @classmethod
    def from_index(cls, index, base_vecs, *, version: int = 0,
                   capacity: int | None = None, delta_len: int | None = None,
                   store_dtype: str = "fp32", store_block: int = 32
                   ) -> "IndexArtifact":
        """Wrap a fitted frozen IRLIIndex (+ its corpus), on the index's
        device: builds the full-capacity buffers the streaming surfaces
        need (one copy, at build time — not on the swap path)."""
        from repro_torch.stream.mutable_index import MutableIRLIIndex
        midx = MutableIRLIIndex(index, base_vecs, capacity=capacity,
                                delta_len=delta_len, store_dtype=store_dtype,
                                store_block=store_block)
        return cls.from_mutable(midx, version=version)

    # -------------------------------------------------------- persistence --
    def state_dict(self) -> dict:
        """Tensors nested for CheckpointManager, in the reference's layout
        (bf16 codes widened to fp32 — exact — as ``store_to_arrays``
        writes them)."""
        arrays = {
            "members": self.members, "delta_members": self.delta.members,
            "delta_fill": self.delta.fill, "tombstone": self.tombstone,
            "load": self.load, "assign": self.assign, "vecs": self.vecs,
        }
        arrays.update(ST.store_to_arrays(self.store))
        if self.replicas is not None:
            arrays["replicas"] = self.replicas
        if self.sketch is not None:
            arrays["sketch"] = self.sketch
        return {"scorer": self.params, "artifact": arrays}

    def extra(self) -> dict:
        return {"artifact_version": int(self.version),
                "n_total": int(self.n_total),
                "checksum": self.checksum, **self.meta_dict}

    def save(self, manager) -> int:
        """Persist through a CheckpointManager (either package's) at step
        == version. Returns the step."""
        manager.save(int(self.version), self.state_dict(), extra=self.extra())
        return int(self.version)

    @classmethod
    def restore(cls, manager, step: int | None = None, *,
                device: str | torch.device = "cuda") -> "IndexArtifact":
        """Load + verify an artifact from a CheckpointManager (either
        package's; the newest intact step when ``step`` is None) onto
        ``device``. Raises ArtifactIntegrityError when the recorded
        checksum does not match the content."""
        dev = resolve_device(device)
        if step is None:
            step, tree, manifest = manager.restore_latest()
        else:
            tree, manifest = manager.restore(step)
        extra = manifest.get("extra", {})
        arrays = tree["artifact"]
        meta_keys = ("d", "n_buckets", "n_reps", "capacity", "loss",
                     "store_dtype", "store_block", "n_base",
                     "sketch_planes", "sketch_seed")
        meta = {k: extra[k] for k in meta_keys if k in extra}
        store = ST.store_from_arrays(
            arrays, str(extra.get("store_dtype", "fp32")),
            int(extra.get("store_block", 32)), device=dev)

        def t(name, dtype):
            return ST.to_tensor(arrays[name], dtype, dev)

        art = cls(
            version=int(extra.get("artifact_version", step)),
            params={k: ST.to_tensor(v, torch.float32, dev)
                    for k, v in tree["scorer"].items()},
            members=t("members", torch.int32),
            delta=DeltaState(members=t("delta_members", torch.int32),
                             fill=t("delta_fill", torch.int32)),
            tombstone=t("tombstone", torch.bool),
            load=t("load", torch.int32),
            assign=t("assign", torch.int32),
            vecs=t("vecs", torch.float32),
            n_total=int(extra["n_total"]),
            meta=tuple(sorted(meta.items())), store=store,
            replicas=(t("replicas", torch.int32)
                      if "replicas" in arrays else None),
            sketch=(t("sketch", torch.float32)
                    if "sketch" in arrays else None),
            checksum=str(extra.get("checksum", "")))
        art.verify()
        return art

    # ------------------------------------------------------------- install --
    def install(self, target) -> None:
        """Swap this artifact into a serving surface (MutableIRLIIndex or
        frozen IRLIIndex) — dispatches to its ``install_artifact``."""
        install = getattr(target, "install_artifact", None)
        if install is None:
            raise TypeError(
                f"{type(target).__name__} has no install_artifact — "
                "artifact swap targets are IRLIIndex / MutableIRLIIndex")
        install(self)

    def empty_delta(self) -> DeltaState:
        """A fresh, all-empty delta shaped like this artifact's, on its
        device."""
        R, B, DL = self.delta.members.shape
        return delta_init(R, B, DL, self.delta.members.device)
