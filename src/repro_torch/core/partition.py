"""Row-block partition spec for feature-fusion weight matrices (Eq. 3).

Port of ``repro.core.partition``. Describes how the rows of W
(concatenated feature dim D) split into user/item/cross blocks and derives
FLOPs/bytes for roofline accounting (``chip_smoke.py``'s Table 2 prints
both ratios beside the times).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.mari import mari_flops, vanilla_flops


@dataclasses.dataclass(frozen=True)
class WeightPartition:
    d_user: int
    d_item: int
    d_cross: int
    d_out: int

    @property
    def d_in(self) -> int:
        return self.d_user + self.d_item + self.d_cross

    @property
    def d_rest(self) -> int:
        return self.d_item + self.d_cross

    def row_slices(self) -> dict[str, slice]:
        o1, o2 = self.d_user, self.d_user + self.d_item
        return {"user": slice(0, o1), "item": slice(o1, o2),
                "cross": slice(o2, self.d_in)}

    def split(self, w):
        """The user / item / cross row blocks of a (D, d) weight (a tensor
        or an array; each block is a view)."""
        sl = self.row_slices()
        return {k: w[s] for k, s in sl.items()}

    # -- accounting ----------------------------------------------------------
    def flops_vanilla(self, batch: int) -> int:
        return vanilla_flops(batch, self.d_in, self.d_out)

    def flops_mari(self, batch: int) -> int:
        return mari_flops(batch, self.d_user, self.d_rest, self.d_out)

    def flops_speedup(self, batch: int) -> float:
        return self.flops_vanilla(batch) / self.flops_mari(batch)

    def bytes_vanilla(self, batch: int, itemsize: int = 4) -> int:
        # read tiled X (B, D), W (D, d); write (B, d)
        return itemsize * (batch * self.d_in + self.d_in * self.d_out
                           + batch * self.d_out)

    def bytes_mari(self, batch: int, itemsize: int = 4) -> int:
        # read X_u (1, D_u), X_rest (B, D_rest), W (D, d); write (B, d)
        return itemsize * (self.d_user + batch * self.d_rest
                           + self.d_in * self.d_out + batch * self.d_out)
