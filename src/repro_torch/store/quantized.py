"""QuantizedStore — the tiered vector payload behind every rerank surface.
Port of ``repro/store/quantized.py``.

  coarse tier — block-scaled codes: ``codes [L, D]`` int8 (or bf16) plus
      per-row-block fp32 ``scales [L, D/block]`` (int8 only). Candidate
      scoring gathers CODE rows.
  exact tier — optional fp32 rows (``exact``) the refine stage re-scores;
      without it the refine re-scores on-the-fly dequantized rows.

``dtype="fp32"`` is the identity store: ``codes`` IS the fp32 base.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

STORE_DTYPES = ("fp32", "int8", "bf16")


@dataclasses.dataclass(frozen=True)
class QuantizedStore:
    """Block-scaled quantized vector rows + optional exact fp32 tier.

    codes  [L, D]        int8 ("int8") | bfloat16 ("bf16") | float32 ("fp32")
    scales [L, D/block]  fp32 per-row-block scales ("int8" only, else None)
    exact  [L, D]        optional fp32 refine tier (None = dequant refine)
    """
    dtype: str
    block: int
    codes: torch.Tensor
    scales: torch.Tensor | None = None
    exact: torch.Tensor | None = None

    @property
    def shape(self):
        return self.codes.shape

    @property
    def n_rows(self) -> int:
        return self.codes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def nbytes(self) -> int:
        """Resident bytes of the coarse tier (codes + scales)."""
        n = self.codes.numel() * self.codes.element_size()
        if self.scales is not None:
            n += self.scales.numel() * self.scales.element_size()
        return int(n)

    def append(self, ids, x) -> "QuantizedStore":
        """Write rows ``x`` [n, D] at row indices ``ids`` [n], encoded with
        THIS store's dtype and block, into copies of its tensors -> a new
        store; the caller swaps it in (the streaming snapshot discipline:
        readers of this store never see the write). A row's codes and
        scales equal those of a full :func:`encode` of the same rows."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        ids = torch.as_tensor(ids, device=self.device).long()
        enc = encode(x, self.dtype, self.block)

        def put(dst, src):
            if dst is None:
                return None
            out = dst.clone()
            out[ids] = src
            return out

        return QuantizedStore(self.dtype, self.block,
                              put(self.codes, enc.codes),
                              put(self.scales, enc.scales),
                              put(self.exact, x))


def _check_dtype(dtype: str) -> None:
    if dtype not in STORE_DTYPES:
        raise ValueError(f"store dtype must be one of {STORE_DTYPES}, "
                         f"got {dtype!r}")


def check_scales(store: QuantizedStore) -> None:
    """int8 codes need their scales; only int8 stores carry scales."""
    _check_dtype(store.dtype)
    if store.dtype == "int8" and store.scales is None:
        raise ValueError("an int8 QuantizedStore requires scales")
    if store.dtype != "int8" and store.scales is not None:
        raise ValueError(f"scales are only valid for int8 stores, got "
                         f"dtype={store.dtype!r}")


def encode(x: torch.Tensor, dtype: str = "int8", block: int = 32, *,
           keep_exact: bool = False) -> QuantizedStore:
    """Encode fp32 rows [L, D] into a QuantizedStore.

    int8 block-scaling: per (row, block) scale = max|x| / 127 (all-zero
    blocks get 1/127), codes = round-half-even(x / scale) — bit-identical to
    the reference's ``encode``. ``keep_exact`` retains ``x`` as the fp32
    refine tier."""
    _check_dtype(dtype)
    x = x.to(torch.float32)
    if x.ndim != 2:
        raise ValueError(f"encode expects [L, D] rows, got shape "
                         f"{tuple(x.shape)}")
    exact = x if keep_exact else None
    if dtype == "fp32":
        return QuantizedStore("fp32", block, x, None, exact)
    if dtype == "bf16":
        return QuantizedStore("bf16", block, x.to(torch.bfloat16), None,
                              exact)
    L, D = x.shape
    block = min(block, D)
    if D % block != 0:
        raise ValueError(f"scale block {block} must divide D={D}")
    xb = x.reshape(L, D // block, block)
    amax = xb.abs().amax(dim=-1)                               # [L, nb]
    scales = torch.where(amax > 0, amax, torch.ones_like(amax)) / 127.0
    codes = torch.round(xb / scales[..., None]).to(torch.int8)
    return QuantizedStore("int8", block, codes.reshape(L, D), scales, exact)


def dequant_gathered(codes, scales, ids, block: int) -> torch.Tensor:
    """THE block-dequant expression: gather rows ``ids`` from codes [L, D]
    + scales [L, D/block] and widen to fp32 [..., D]. ``scales=None``
    (bf16 codes) is a plain widening gather."""
    rows = codes[ids].to(torch.float32)
    if scales is None:
        return rows
    return rows * torch.repeat_interleave(scales[ids], block, dim=-1)


def dequant_rows(store: QuantizedStore, ids) -> torch.Tensor:
    """Gather + dequantize rows by index: ids [...] -> fp32 [..., D]."""
    if store.dtype == "fp32":
        return store.codes[ids]
    if store.dtype == "bf16":
        return store.codes[ids].to(torch.float32)
    return dequant_gathered(store.codes, store.scales, ids, store.block)


def decode(store: QuantizedStore) -> torch.Tensor:
    """Full fp32 decode [L, D] — for tests and offline tooling only."""
    return dequant_rows(store, torch.arange(store.n_rows,
                                            device=store.device))


def refine_rows(store: QuantizedStore, ids) -> torch.Tensor:
    """The refine tier's view of rows ``ids``: exact fp32 when the store
    keeps an exact tier, on-the-fly dequantized otherwise."""
    if store.exact is not None:
        return store.exact[ids]
    return dequant_rows(store, ids)


# ------------------------------------------------------------ serialization --
def store_to_arrays(store: QuantizedStore | None, prefix: str = "store_"
                    ) -> dict:
    """Flatten a store into npz-safe tensors: ``{prefix}codes`` (+
    ``{prefix}scales`` for int8). bf16 codes are widened to fp32 — npz has
    no bf16 — which is exact; :func:`store_from_arrays` re-casts. The exact
    tier is not serialized: its owner keeps the fp32 rows as a leaf of its
    own. The reference's layout, so either package restores the other's."""
    if store is None:
        return {}
    out = {prefix + "codes": (store.codes if store.codes.dtype == torch.int8
                              else store.codes.to(torch.float32))}
    if store.scales is not None:
        out[prefix + "scales"] = store.scales
    return out


def to_tensor(x, dtype: torch.dtype,
              device: str | torch.device = "cpu") -> torch.Tensor:
    """A numpy array (copied: a restored or JAX-exported array may be read
    only) or a tensor -> a tensor of ``dtype`` on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=device, dtype=dtype)


def store_from_arrays(arrays: dict, dtype: str, block: int,
                      prefix: str = "store_",
                      device: str | torch.device = "cpu"
                      ) -> QuantizedStore | None:
    """Inverse of :func:`store_to_arrays` (numpy or tensors) on ``device``
    -> the store, or None when the arrays carry no ``{prefix}codes``."""
    if prefix + "codes" not in arrays:
        return None
    _check_dtype(dtype)
    codes = to_tensor(arrays[prefix + "codes"],
                      {"fp32": torch.float32, "int8": torch.int8,
                       "bf16": torch.bfloat16}[dtype], device)
    scales = (to_tensor(arrays[prefix + "scales"], torch.float32, device)
              if prefix + "scales" in arrays else None)
    return QuantizedStore(dtype, int(block), codes, scales)
