"""The weight-gradient product the all-gradients backwards share
(``csrc/grad_common.cuh`` ``wgrad_kernel``): ``dW = dY^T . X`` over the
tokens, both operands stored width-major in bf16 (a row per channel or hidden
unit, ``token_ld`` tokens a row), so that both are K-major wgmma operands
read by TMA.  A block owns a 128 x 128 tile of dW; the tokens' 64-token
slices are split over a thread-block cluster of ``splits`` blocks, whose
partials are added in rank order.  :func:`wgrad_plan` is what the kernel is
handed, plain Python so that the CPU tests reach it.
"""
from dataclasses import dataclass
from functools import lru_cache

TILE, SLICE = 128, 64            # csrc/grad_common.cuh wgrad::kBM / kBN; tokens a slice
SPLITS, SMS = (1, 2, 4, 8), 132  # the cluster sizes that pack into the H100's GPCs; its SMs
STAGES, STAGE_BYTES, CONSUMERS = 4, 2 * TILE * 128, 256


def token_ld(M: int) -> int:
    """The row stride (tokens) of a width-major operand: M rounded up to 64,
    so that each 64-token tile of a backward writes whole 16-byte groups."""
    return -(-M // SLICE) * SLICE


@dataclass(frozen=True)
class WgradPlan:
    """dW (P, Q) over M tokens: tiles of ``TILE`` x ``TILE``, each a cluster
    of ``splits`` blocks over the token slices."""
    P: int
    Q: int
    M: int
    splits: int

    @property
    def tiles(self):
        return -(-self.P // TILE), -(-self.Q // TILE)

    @property
    def slices(self) -> int:
        return -(-self.M // SLICE)

    def slice_range(self, rank: int) -> range:
        """The 64-token slices that rank ``rank`` of a cluster adds."""
        return range(rank * self.slices // self.splits, (rank + 1) * self.slices // self.splits)

    def tile(self, p_tile: int, q_tile: int):
        """(rows, columns) of dW that the cluster of (p_tile, q_tile) writes."""
        return (range(p_tile * TILE, min(self.P, (p_tile + 1) * TILE)),
                range(q_tile * TILE, min(self.Q, (q_tile + 1) * TILE)))

    def rank_groups(self, rank: int) -> range:
        """The 8-column groups of a tile whose sum rank ``rank`` writes."""
        return range(rank, TILE // 8, self.splits)

    @property
    def smem_bytes(self) -> int:
        return 1024 + STAGES * STAGE_BYTES

    @property
    def partial_bytes(self) -> int:
        """The f32 partial a block parks in its ring for the cluster's sum."""
        return TILE * TILE * 4


@lru_cache(maxsize=None)
def wgrad_plan(P: int, Q: int, M: int) -> WgradPlan:
    """The most splits of ``SPLITS`` (at most one per slice) that keep every
    block in one wave over the ``SMS`` SMs."""
    tp, tq = -(-P // TILE), -(-Q // TILE)
    slices = -(-M // SLICE)
    splits = max(s for s in SPLITS if s == 1 or (s <= slices and tp * tq * s <= SMS))
    return WgradPlan(P, Q, M, splits)
