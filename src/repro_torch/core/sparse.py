"""The port's sparse matrix value, `BCOO`: jax's batched-COO layout with
no batch or dense dimensions, on torch tensors."""
from __future__ import annotations

import torch


class BCOO:
    """A sparse matrix in jax's BCOO layout (no batch or dense dims).

    `data` (nse,) holds the values, `indices` (nse, 2) int32 their (row,
    col) positions. Duplicate indices add up. `torch.sparse_coo_tensor` is
    not used: its int64 indices would double the index bytes that the
    reuse pool and the streaming lane charge, which feed eviction and
    bucket sizes and must match the reference's."""

    __slots__ = ("data", "indices", "shape", "indices_sorted",
                 "unique_indices")

    def __init__(self, data: torch.Tensor, indices: torch.Tensor, shape,
                 indices_sorted: bool = False, unique_indices: bool = False):
        if indices.dtype != torch.int32 or indices.ndim != 2 \
                or indices.shape[1] != 2 or data.shape != indices.shape[:1]:
            raise ValueError(
                f"BCOO: data {tuple(data.shape)} and int32 indices (nse, 2) "
                f"expected, got {tuple(indices.shape)} {indices.dtype}")
        self.data = data
        self.indices = indices
        self.shape = tuple(int(d) for d in shape)
        self.indices_sorted = bool(indices_sorted)
        self.unique_indices = bool(unique_indices)

    @property
    def nse(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def with_data(self, data: torch.Tensor) -> "BCOO":
        """The same structure holding other values."""
        return BCOO(data, self.indices, self.shape, self.indices_sorted,
                    self.unique_indices)

    def to(self, device) -> "BCOO":
        return BCOO(self.data.to(device), self.indices.to(device),
                    self.shape, self.indices_sorted, self.unique_indices)

    def todense(self) -> torch.Tensor:
        """Dense copy. Duplicate indices accumulate (`index_put_` with
        accumulate, in a fixed order): the zero-valued padding repeats the
        last real index, and a plain scatter could let a padding 0
        overwrite its value. Entries equal to 0 are left out first: adding
        one changes no bit of a +0-initialised sum, and the padding's one
        long run of equal indices would otherwise serialise the
        accumulating scatter on the card (~0.4 s at 8 M nse)."""
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        keep = self.data != 0
        idx = self.indices[keep].long()
        out.index_put_((idx[:, 0], idx[:, 1]), self.data[keep],
                       accumulate=True)
        return out

    @property
    def T(self) -> "BCOO":
        """Transpose: the index columns swap, so the rows are no longer in
        order (`indices_sorted` is False)."""
        return BCOO(self.data, self.indices.flip(1), self.shape[::-1],
                    indices_sorted=False, unique_indices=self.unique_indices)

    def __repr__(self) -> str:
        return (f"BCOO(shape={self.shape}, nse={self.nse}, dtype={self.dtype}, "
                f"device={self.device})")
