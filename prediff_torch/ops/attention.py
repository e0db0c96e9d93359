"""Whole-layer cuboid attention: the axial layer on the natural
(B, T, H, W, C) layout, the general cuboid layer on cuboid_reorder's layout,
and the grouped masked core of shifted and padded windows.

Axial layer.

``LN -> . Wqkv^T -> per head softmax(q . scale . k^T + relbias[h]) . v ->
. Wproj^T + b`` along one axis (0: T, 1: H, 2: W), with no residual.  The
kernel (``csrc/attention.cu``) replaces
``prediff_tpu/ops/pallas_attention.py::fused_axial_attention_5d``.  It runs
as three hand-written launches (LN+QKV product and output projection on TMA
+ wgmma with the bf16 weights of ``ops/weights.py``, :func:`attention_plan`
their tiles; between them the per-cuboid core, which reads cuboids in place
by strides); matrix products take bf16 operands with f32 accumulation, and
q, k, v and the head outputs pass between the launches as bf16.  Its input
gradient (``axial_attention_bwd_dx``, same source) replaces
``pallas_attention.py::fused_axial_attention_5d_bwd_dx``, and its
all-gradients backward (``axial_attention_bwd_full``) replaces
``pallas_attention.py::fused_axial_attention_5d_bwd_full``: both recompute
LN + QKV with the forward's product and run dattn and dln on the same
product with the transposed bf16 weights of ``ops/weights.py``
(:func:`axial_bwd_plan`), the weight gradients on ``ops/wgrad.py``'s.  With dropout
(``axial_attention_dropout_forward``, ``axial_attention_dropout_bwd_full``)
they replace the ``seed=`` forms of those two: ``p . m_a / (1 - rate_attn)``
after the softmax and before ``p . v``, and ``(. Wproj^T + b) . m_p /
(1 - rate_proj)`` on the output, the masks those of ``ops/dropout.py`` for
``(seed, site)`` (tensor 0: (B * cuboids, heads, vol, vol) with the cuboids
in ``cuboid_reorder``'s order, tensor 1: the natural (B, T, H, W, C)),
regenerated in the backward; the seed a host integer or a device seed, read
by the kernels from its address (the general layer's dropout forms alike).
Weights are in PyTorch layout: ``w_qkv``
(3C, C), ``w_proj`` (C, C); ``bias`` is (heads, vol, vol).

:func:`fused_axial_attention` is differentiable.  When a parameter gradient
is asked for (training) its backward is one call of
:func:`fused_axial_attention_bwd_full`, which gives dx and every parameter
gradient; when only dx is asked for (guidance: the model is frozen) it is
:func:`fused_axial_attention_bwd_dx`.  With a ``seed`` it runs
:func:`fused_axial_attention_dropout` and, backward,
:func:`fused_axial_attention_dropout_bwd_full`.

General cuboid layer (:func:`fused_cuboid_attention_layer`): the same
function on x already reordered into (B, cuboids, vol, C) by
``cuboid_reorder``, for any unshifted, unpadded cuboid of vol <= 256
(``V4_MAX_ROWS``); ``bias`` (heads, vol, vol) is indexed in the reorder's
within-cuboid order.  Its kernel replaces
``pallas_attention.py::fused_cuboid_attention_layer_v4``: the axial
forward's two products around a core on the tensor cores (bf16 ``mma.sync``,
p in registers), tiled by :func:`cuboid_layer_plan`; its input
gradient (:func:`fused_cuboid_attention_layer_bwd_dx`)
``fused_cuboid_attention_layer_v4_bwd_dx``: the axial backward's launches
around a gradient core of its own on the tensor cores (:func:`cuboid_bwd_plan`),
with the axial kernels' bf16 rounding points; its all-gradients backward
(:func:`fused_cuboid_attention_layer_bwd_full`)
``fused_cuboid_attention_layer_v4_bwd_full``, and with dropout
(:func:`fused_cuboid_attention_layer_dropout`,
:func:`fused_cuboid_attention_layer_dropout_bwd_full`) the ``seed=`` forms of
those two, the masks on x's layout: tensor 0 (B, cuboids, heads, vol, vol),
tensor 1 the projected output (B, cuboids, vol, C) before the reverse
reorder.  The axial plain versions are these on the axis's cuboids.
:func:`fused_cuboid_attention_layer` is differentiable and picks its
backward kernel as :func:`fused_axial_attention` does (the JAX package's
``full_bwd = not deterministic``).

Grouped core (:func:`fused_cuboid_attention_grouped`):
``masked_softmax(q . scale . k^T + bias[h]) . v`` on the head-major
(B, heads, cuboids, vol, hc) layout, mask (cuboids, vol, vol) or None, all
f32.  Its kernel replaces ``pallas_attention.py::fused_cuboid_attention_grouped``
and takes any vol; its backward is autograd of the plain version, as the JAX
package's is ``jax.vjp`` of its reference.

bf16 forms.  The axial layer and its dx, the general layer and its dx, and
the grouped core also take bf16 activations (x, g, out, dx; q, k, v): the
same kernels reading and writing bf16 (``_build.io_form``'s ``_bf16`` entry
points, counted in ``.bf16_launches`` beside ``.launches``), which a
forecast on bf16 parameters and guidance in bf16 run.  The bias and the
parameter vectors stay f32 (``ops/weights.f32`` widens a bf16 one), a bf16
weight is its own bf16 operand.  Their plain versions widen the inputs, run
the f32 plain version and round the output once.

Round-1 ops, which no model calls (the JAX package's models do not either):
:func:`fused_cuboid_attention`, the per-cuboid core on the cuboid-major
(B, cuboids, heads, vol, hc) layout, replaces
``pallas_attention.py::fused_cuboid_attention`` (the grouped core's kernel
reading that layout by strides), and :func:`fused_cuboid_attention_layer_v3`,
the whole layer on reordered cuboids without a mask, replaces
``pallas_attention.py::fused_cuboid_attention_layer`` (the JAX docstring's
"v3"; the port's :func:`fused_cuboid_attention_layer` is the v4 layer).  Both
are f32 throughout, as the TPU kernels compute them, and forward-only, as
theirs are (no VJP): a call that would need a gradient raises.
"""
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import torch

from . import _build, weights, wgrad
from .cuboid import cuboid_reorder, cuboid_reorder_reverse, masked_softmax
from .dropout import apply_mask, as_seed, cuboid_layer_masks, resolve_masks
from .ffn import _round, layer_norm_bwd_plain, layer_norm_plain

_P, _I, _F, _DROP = _build.P, _build.I, _build.F, _build.DROP_ARGTYPES
_SIGNATURES = {"axial_attention_forward": [_P] * 10 + [_I] * 8 + [_F, _F, _P],
               "axial_attention_bwd_dx": [_P] * 14 + [_I] * 8 + [_F, _F, _P],
               "axial_attention_forward_bf16": [_P] * 10 + [_I] * 8 + [_F, _F, _P],
               "axial_attention_bwd_dx_bf16": [_P] * 14 + [_I] * 8 + [_F, _F, _P],
               "axial_attention_bwd_full": [_P] * 25 + [_I] * 12 + [_F, _F, _P],
               "axial_attention_dropout_forward": [_P] * 10 + [_I] * 8 + [_F, _F] + _DROP + [_P],
               "axial_attention_dropout_bwd_full": ([_P] * 25 + [_I] * 12 + [_F, _F] + _DROP
                                                    + [_P]),
               "cuboid_attention_forward": [_P] * 10 + [_I] * 8 + [_F, _F, _P],
               "cuboid_attention_forward_bf16": [_P] * 10 + [_I] * 8 + [_F, _F, _P],
               "cuboid_attention_dropout_forward": [_P] * 10 + [_I] * 8 + [_F, _F] + _DROP + [_P],
               "cuboid_attention_bwd_dx": [_P] * 15 + [_I] * 7 + [_F, _F, _P],
               "cuboid_attention_bwd_dx_bf16": [_P] * 15 + [_I] * 7 + [_F, _F, _P],
               "cuboid_attention_bwd_full": [_P] * 26 + [_I] * 11 + [_F, _F, _P],
               "cuboid_attention_dropout_bwd_full": ([_P] * 26 + [_I] * 11 + [_F, _F] + _DROP
                                                     + [_P]),
               "cuboid_attention_grouped": [_P] * 6 + [_I] * 5 + [_F, _P],
               "cuboid_attention_grouped_bf16": [_P] * 6 + [_I] * 5 + [_F, _P],
               "cuboid_core_forward": [_P] * 6 + [_I] * 5 + [_F, _P],
               "cuboid_layer_v3_forward": [_P] * 11 + [_I] * 5 + [_F, _F, _P],
               **weights.MAP_SIGNATURE}
# the most rows of one cuboid the general layer takes (the JAX package's v4 gate)
V4_MAX_ROWS = 256
SMEM_BYTES = 227 * 1024   # shared memory one block may use on an H100
# csrc/attention.cu fwd: the axial forward's products on TMA + wgmma
GEMM_ROWS, GEMM_MAX_STAGES, GEMM_SMEM_CAP, LN_MAX_K = 128, 4, 232448 - 128, 768
SMS = 132
VEC_ROWS = 8   # csrc/grad_common.cuh kVecRows: rows per partial of the vector gradients


@dataclass(frozen=True)
class GemmPlan:
    """One of the axial forward's products (``csrc/attention.cu``
    ``fwd_gemm_kernel``): out (M, N) = A (M, K) . W (N, K)^T in tiles of
    ``GEMM_ROWS`` x ``bn``; with ``ln`` A = LN(x) held whole in shared memory
    (the QKV product), else A comes by TMA beside W (the projection)."""
    M: int
    N: int
    K: int
    bn: int
    ln: bool

    @property
    def m_tiles(self) -> int:
        return -(-self.M // GEMM_ROWS)

    @property
    def n_tiles(self) -> int:
        return -(-self.N // self.bn)

    def tile(self, m_tile: int, n_tile: int):
        """(rows, columns) of the output that block (n_tile, m_tile) writes."""
        return (range(m_tile * GEMM_ROWS, min(self.M, (m_tile + 1) * GEMM_ROWS)),
                range(n_tile * self.bn, min(self.N, (n_tile + 1) * self.bn)))

    @property
    def stage_bytes(self) -> int:
        return (0 if self.ln else GEMM_ROWS * 128) + self.bn * 128

    @property
    def stages(self) -> int:
        """The ring's depth (``stages_for``): 0 where even two do not fit."""
        free = GEMM_SMEM_CAP - 1024 - (GEMM_ROWS * self.K * 2 if self.ln else 0)
        s = free // self.stage_bytes
        return 0 if s < 2 else min(s, GEMM_MAX_STAGES)

    @property
    def smem_bytes(self) -> int:
        return 1024 + (GEMM_ROWS * self.K * 2 if self.ln else 0) + self.stages * self.stage_bytes

    @property
    def accumulators(self) -> int:
        """f32 registers a consumer thread holds: 64 rows x bn over 128 threads."""
        return self.bn // 2


@lru_cache(maxsize=None)
def attention_plan(M: int, C: int):
    """(QKV, projection) plans of the axial forward at M tokens of width C:
    the QKV product in 128 x 256 tiles where 3C allows it, the ring fits and
    that still fills half the SMs, else 128 x 128; the projection in 128 x
    128.  Raises where the LN tile cannot be held (C above ``LN_MAX_K``)."""
    m_tiles = -(-M // GEMM_ROWS)
    wide = GemmPlan(M, 3 * C, C, 256, True)
    qkv = wide if (3 * C % 256 == 0 and m_tiles * wide.n_tiles >= SMS // 2
                   and wide.stages >= 2) else GemmPlan(M, 3 * C, C, 128, True)
    if C > LN_MAX_K or qkv.stages == 0:
        raise ValueError(f"attention kernel: C={C} exceeds the forward's LayerNorm tile "
                         f"(at most {LN_MAX_K} channels)")
    return qkv, GemmPlan(M, C, C, 128, False)


@dataclass(frozen=True)
class AxialBwdPlan:
    """The axial backward's launches (``csrc/attention.cu``
    ``axial_bwd_launches``) at M tokens of width C, cuboids of ``vol`` rows:
    the forward's LN + QKV product (past the LN tile on bf16 LN rows by
    TMA), the products ``dattn = do . Wproj`` and ``dln = dqkv . Wqkv`` on
    the transposed weights by TMA, the core in blocks of ``per_block``
    cuboids (one per (block, head)) over f32 tiles in ``core_smem`` bytes,
    and the two weight gradients on the wgmma TN product over width-major
    operands of ``ld`` tokens a row."""
    qkv: GemmPlan
    dattn: GemmPlan
    dln: GemmPlan
    per_block: int
    core_blocks: int
    core_smem: int
    wgrad_qkv: wgrad.WgradPlan
    wgrad_proj: wgrad.WgradPlan
    ld: int


@lru_cache(maxsize=None)
def axial_bwd_plan(M: int, C: int, vol: int, heads: int) -> AxialBwdPlan:
    n_cuboids = M // vol
    # cuboids per core block: the core is bound by latency, so about eight
    # blocks per SM first, then fewer dbias partials
    per_block = max(1, min(8, n_cuboids * heads // (8 * SMS)))
    qkv, dattn, dln, wgrad_qkv, wgrad_proj, ld = _bwd_products(M, C)
    hc = C // heads
    return AxialBwdPlan(qkv, dattn, dln, per_block, -(-n_cuboids // per_block),
                        4 * (4 * vol * (hc + 1) + 3 * vol * vol), wgrad_qkv, wgrad_proj, ld)


def _bwd_products(M: int, C: int):
    """What every layer backward (``csrc/attention.cu`` ``layer_bwd_launches``)
    runs around its core at M tokens of width C: the forward's LN + QKV
    product (past the LN tile on bf16 LN rows by TMA), ``dattn = do . Wproj``
    and ``dln = dqkv . Wqkv``, the two weight gradients and the row stride of
    their width-major operands."""
    qkv = (attention_plan(M, C)[0] if C <= LN_MAX_K else GemmPlan(M, 3 * C, C, GEMM_ROWS, False))
    return (qkv, GemmPlan(M, C, C, GEMM_ROWS, False), GemmPlan(M, C, 3 * C, GEMM_ROWS, False),
            wgrad.wgrad_plan(3 * C, C, M), wgrad.wgrad_plan(C, C, M), wgrad.token_ld(M))


@dataclass(frozen=True)
class CoreTile:
    """The general layer's forward core (``csrc/attention.cu``
    ``cuboid_tc_core_kernel``): one block per (cuboid, head, ``rows`` query
    rows), a warp per 16 rows; k and v of the whole cuboid (``vol16`` rows,
    zeros past vol) and the block's q rows in shared memory as bf16 rows of
    ``hcp`` channels (hc rounded up to 16, zeros past hc) at a stride of
    ``hcp + 8``; p of ``key_tiles`` 64-key tiles in registers."""
    n_cuboids: int
    heads: int
    vol: int
    hc: int
    rows: int

    @property
    def hcp(self) -> int:
        return -(-self.hc // 16) * 16

    @property
    def vol16(self) -> int:
        return -(-self.vol // 16) * 16

    @property
    def key_tiles(self) -> int:
        """The kernel instance: 64-key tiles of p a warp holds (1, 2 or 4)."""
        return next(t for t in (1, 2, 4) if self.vol <= 64 * t)

    @property
    def blocks(self):
        """The grid: (cuboids, heads, query tiles)."""
        return self.n_cuboids, self.heads, -(-self.vol // self.rows)

    @property
    def smem_bytes(self) -> int:
        return 2 * (self.hcp + 8) * (2 * self.vol16 + self.rows)

    @property
    def fragment_registers(self) -> int:
        """32-bit registers of fragment state a thread holds: p (bf16 pairs,
        4 per 16 keys), a 16 x 64 score tile and a 16 x 64 output slice (32
        f32 each), one q fragment (4)."""
        return 16 * self.key_tiles + 32 + 32 + 4

    def tile(self, cuboid: int, head: int, z: int, warp: int) -> range:
        """The query rows of (cuboid, head) that warp ``warp`` of block z writes."""
        r0 = z * self.rows + 16 * warp
        return range(min(r0, self.vol), min(r0 + 16, self.vol))


@dataclass(frozen=True)
class CuboidLayerPlan:
    """The general layer's three launches: the QKV product (with the LN tile
    where C <= ``LN_MAX_K``, else on bf16 LN rows by TMA), the core, the
    projection."""
    qkv: GemmPlan
    core: CoreTile
    proj: GemmPlan


@lru_cache(maxsize=None)
def cuboid_layer_plan(n_cuboids: int, vol: int, C: int, heads: int) -> CuboidLayerPlan:
    """The products as the axial forward tiles them (:func:`attention_plan`)
    over M = cuboids x vol rows; where C exceeds the LN tile, the QKV product
    reads bf16 LN rows by TMA in 128 x 128 tiles instead.  The core in
    blocks of the most of 64, 32, 16 query rows (at most vol rounded up to
    16) that fits shared memory: the cuboid's k and v are copied once for
    more rows, and the warps of a block hide each other's latency (on the
    H100, 64-row blocks beat 16-row ones at every UNet shape, also where they
    leave SMs idle); raise where none fits."""
    M, hc = n_cuboids * vol, C // heads
    if C <= LN_MAX_K:
        qkv, proj = attention_plan(M, C)
    else:
        qkv, proj = GemmPlan(M, 3 * C, C, 128, False), GemmPlan(M, C, C, 128, False)
    fits = [t for t in (CoreTile(n_cuboids, heads, vol, hc, rows) for rows in (64, 32, 16)
                        if rows <= -(-vol // 16) * 16)
            if t.smem_bytes <= GEMM_SMEM_CAP]
    if not fits:
        raise ValueError(f"cuboid attention kernel: a cuboid of {vol} rows x {hc} head channels "
                         "does not fit in shared memory")
    return CuboidLayerPlan(qkv, fits[0], proj)


@dataclass(frozen=True)
class CuboidBwdPlan:
    """The general layer's backward (``csrc/attention.cu``
    ``cuboid_bwd_launches``) at ``n_cuboids`` cuboids of ``vol`` rows x C:
    the axial backward's products and weight gradients (as
    :func:`axial_bwd_plan` tiles them) around a gradient core on the tensor
    cores.  ``fused``: one launch (``cuboid_bwd_core_kernel``), a block per
    (``per_block`` cuboids, head) with ``vol16 / 16`` warps, a whole cuboid's
    bf16 q . scale, k, v, dattn (``vol16`` rows of ``hcp`` channels at a
    stride of ``hcp + 8``) and its bf16 ds and dropped p (``vol16`` x
    ``vol16 + 8``) in shared memory, one dbias partial per block.  Else the
    split pair (``cuboid_bwd_q_kernel``, ``cuboid_bwd_kv_kernel``), a block
    per (cuboid, head, ``rows`` rows) with k and v (then q . scale and dattn
    and the rows' statistics) of the whole cuboid in shared memory, one dbias
    partial per cuboid."""
    qkv: GemmPlan
    dattn: GemmPlan
    dln: GemmPlan
    n_cuboids: int
    vol: int
    hc: int
    heads: int
    fused: bool
    rows: int
    per_block: int
    wgrad_qkv: wgrad.WgradPlan
    wgrad_proj: wgrad.WgradPlan
    ld: int

    @property
    def hcp(self) -> int:
        return -(-self.hc // 16) * 16

    @property
    def vol16(self) -> int:
        return -(-self.vol // 16) * 16

    @property
    def parts(self) -> int:
        """The dbias partials the fixed-order sum adds."""
        return -(-self.n_cuboids // self.per_block) if self.fused else self.n_cuboids

    @property
    def core_smem(self) -> int:
        """Shared memory of the core's largest block."""
        operand = 2 * (self.hcp + 8) * self.vol16
        if self.fused:
            return 4 * operand + 2 * 2 * self.vol16 * (self.vol16 + 8)
        return 2 * operand + 4 * 3 * self.vol16

    @property
    def key_tiles(self) -> int:
        """64-key tiles of a query row (the query-row kernel's instance)."""
        return next(t for t in (1, 2, 4) if self.vol <= 64 * t)

    @property
    def fragment_registers(self) -> int:
        """32-bit registers of fragment state a thread holds at most: three
        16 x 64 f32 tiles (s or p, dp, the dropped p) and an output slice (32
        each), and the bf16 fragments of ds and the dropped p (16 per 64 keys;
        the query-row kernel holds one set over all its key tiles, the
        key-row kernel adds the dk and dv sums)."""
        if self.fused:
            return 4 * 32 + 2 * 16
        return max(3 * 32 + 32 + 16 * self.key_tiles, 3 * 32 + 2 * 16 + 2 * 32)

    @property
    def grid(self):
        return ((-(-self.n_cuboids // self.per_block), self.heads) if self.fused
                else (self.n_cuboids, self.heads, -(-self.vol // self.rows)))

    def warp_rows(self, z: int, warp: int) -> range:
        """The rows (query rows, then keys) of its cuboids that warp ``warp``
        of a block at grid z (0 where fused) takes."""
        r0 = (0 if self.fused else z * self.rows) + 16 * warp
        return range(min(r0, self.vol), min(r0 + 16, self.vol))

    def block_cuboids(self, x: int) -> range:
        """The cuboids of a block at grid x."""
        if not self.fused:
            return range(x, x + 1)
        return range(x * self.per_block, min(self.n_cuboids, (x + 1) * self.per_block))


@lru_cache(maxsize=None)
def cuboid_bwd_plan(n_cuboids: int, vol: int, C: int, heads: int) -> CuboidBwdPlan:
    """The fused core where vol <= 64 and it fits a block's shared memory,
    cuboids per block such that about four blocks per SM remain (fewer
    dbias partials past that), else the split pair on 64-row blocks (vol16
    below that); raise where neither fits (never where the forward's
    :func:`cuboid_layer_plan` does: each of the split's blocks holds two of
    the cuboid's tiles, the forward's three)."""
    hc, vol16 = C // heads, -(-vol // 16) * 16
    qkv, dattn, dln, wgrad_qkv, wgrad_proj, ld = _bwd_products(n_cuboids * vol, C)

    def plan(fused: bool, per_block: int) -> CuboidBwdPlan:
        return CuboidBwdPlan(qkv, dattn, dln, n_cuboids, vol, hc, heads, fused, min(64, vol16),
                             per_block, wgrad_qkv, wgrad_proj, ld)

    fused = plan(True, max(1, min(8, n_cuboids * heads // (4 * SMS))))
    if vol <= 64 and fused.core_smem <= GEMM_SMEM_CAP:
        return fused
    split = plan(False, 1)
    if split.core_smem > GEMM_SMEM_CAP:
        raise ValueError(f"cuboid attention kernel: a cuboid of {vol} rows x {hc} head channels "
                         "does not fit in shared memory")
    return split


def axial_cuboid_size(shape, axis: int):
    _, T, H, W, _ = shape
    return ((T, 1, 1), (1, H, 1), (1, 1, W))[axis]


def _qkv_plain(xr, ln_w, ln_b, w_qkv, num_heads, eps, mxu_dtype):
    """LN and the QKV product on reordered cuboids: q, k, v (B, nC, vol, heads, hc)."""
    B, nC, vol, C = xr.shape
    ln = layer_norm_plain(xr, ln_w, ln_b, eps)
    qkv = (_round(ln, mxu_dtype) @ _round(w_qkv, mxu_dtype).T).reshape(
        B, nC, vol, 3, num_heads, C // num_heads)
    return qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]


def _softmax_plain(q, k, bias, scale, mxu_dtype):
    s = torch.einsum("bnihc,bnjhc->bnhij", _round(q * scale, mxu_dtype), _round(k, mxu_dtype))
    s = s + bias
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


_AXIAL = ("l", "l", "l")


def _axial_reordered(x, axis, num_heads, rate_attn, rate_proj, seed, site, masks, bases):
    """x in cuboids (B, nC, vol, C), f32, its cuboid size, and the dropout
    masks (m_a (B, nC, heads, vol, vol), m_p natural (B, T, H, W, C)) with m_p
    reordered as x, None at rate 0."""
    B, T, H, W, C = x.shape
    vol = (T, H, W)[axis]
    cs = axial_cuboid_size(x.shape, axis)
    m_a, m_p = resolve_masks((rate_attn, rate_proj),
                             ((B, T * H * W // vol, num_heads, vol, vol), (B, T, H, W, C)),
                             seed, site, masks, x.device, bases)
    if m_p is not None:
        m_p = cuboid_reorder(m_p, cs, _AXIAL)
    return cuboid_reorder(x.float(), cs, _AXIAL), cs, (m_a, m_p)


@_build.widened
def axial_attention_plain(x: torch.Tensor, axis: int, ln_w: torch.Tensor, ln_b: torch.Tensor,
                          w_qkv: torch.Tensor, bias: torch.Tensor, w_proj: torch.Tensor,
                          b_proj: torch.Tensor, num_heads: int, scale: float,
                          eps: float = 1e-5, mxu_dtype: Optional[torch.dtype] = None,
                          rate_attn: float = 0.0, rate_proj: float = 0.0,
                          seed: Optional[int] = None, site: int = 0, masks=None,
                          bases=(0, 0)) -> torch.Tensor:
    """Plain PyTorch version: :func:`cuboid_attention_plain` on the axis's
    cuboids (``cuboid_reorder``).  ``mxu_dtype`` rounds the matmul operands
    where the kernel does; ``None`` keeps f32.  Dropout on the attention
    weights (``rate_attn``) and on the projected output (``rate_proj``) with
    the masks of ``(seed, site)`` from the element ``bases``
    (``ops/dropout.py``), or the explicit ``masks = (m_a (B, cuboids, heads,
    vol, vol), m_p (B, T, H, W, C))`` of 0/1 values."""
    xr, cs, drop = _axial_reordered(x, axis, num_heads, rate_attn, rate_proj, seed, site, masks,
                                    bases)
    out = cuboid_attention_plain(xr, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale,
                                 eps, mxu_dtype, rate_attn, rate_proj, masks=drop)
    return cuboid_reorder_reverse(out, cs, _AXIAL, x.shape[1:4]).to(x.dtype)


@_build.widened
def axial_attention_bwd_dx_plain(x: torch.Tensor, g: torch.Tensor, axis: int,
                                 ln_w: torch.Tensor, ln_b: torch.Tensor, w_qkv: torch.Tensor,
                                 bias: torch.Tensor, w_proj: torch.Tensor, num_heads: int,
                                 scale: float, eps: float = 1e-5,
                                 mxu_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain dx of :func:`axial_attention_plain` for the cotangent ``g``:
    :func:`cuboid_attention_bwd_dx_plain` on the axis's cuboids."""
    cs = axial_cuboid_size(x.shape, axis)
    dx = cuboid_attention_bwd_dx_plain(cuboid_reorder(x.float(), cs, _AXIAL),
                                       cuboid_reorder(g.float(), cs, _AXIAL), ln_w, ln_b, w_qkv,
                                       bias, w_proj, num_heads, scale, eps, mxu_dtype)
    return cuboid_reorder_reverse(dx, cs, _AXIAL, x.shape[1:4]).to(x.dtype)


@_build.widened
def axial_attention_bwd_full_plain(x: torch.Tensor, g: torch.Tensor, axis: int,
                                   ln_w: torch.Tensor, ln_b: torch.Tensor, w_qkv: torch.Tensor,
                                   bias: torch.Tensor, w_proj: torch.Tensor, num_heads: int,
                                   scale: float, eps: float = 1e-5,
                                   mxu_dtype: Optional[torch.dtype] = None,
                                   rate_attn: float = 0.0, rate_proj: float = 0.0,
                                   seed: Optional[int] = None, site: int = 0, masks=None,
                                   bases=(0, 0)):
    """Plain (dx, dln_w, dln_b, dw_qkv, dbias, dw_proj, db_proj) of
    :func:`axial_attention_plain` for the cotangent ``g``:
    :func:`cuboid_attention_bwd_full_plain` on the axis's cuboids, with the
    same masks."""
    xr, cs, drop = _axial_reordered(x, axis, num_heads, rate_attn, rate_proj, seed, site, masks,
                                    bases)
    dx, *dparams = cuboid_attention_bwd_full_plain(
        xr, cuboid_reorder(g.float(), cs, _AXIAL), ln_w, ln_b, w_qkv, bias, w_proj, num_heads,
        scale, eps, mxu_dtype, rate_attn, rate_proj, masks=drop)
    return (cuboid_reorder_reverse(dx, cs, _AXIAL, x.shape[1:4]).to(x.dtype), *dparams)


def _axial_refusal(shape, axis: int, num_heads: int, forward: bool = True) -> Optional[str]:
    """Why the axial kernels refuse x of ``shape`` (B, T, H, W, C) along
    ``axis``, or None where they all launch; ``forward=False``: the
    backwards alone, which take C past the forward's LayerNorm tile."""
    B, T, H, W, C = shape
    if C % 64 != 0 or C % num_heads != 0 or axis not in (0, 1, 2):
        return (f"attention kernel: C={C} (takes multiples of 64), heads={num_heads}, "
                f"axis={axis} not supported")
    if forward and C > LN_MAX_K:
        return (f"attention kernel: C={C} exceeds the forward's LayerNorm tile "
                f"(at most {LN_MAX_K} channels)")
    vol = (T, H, W)[axis]
    # the gradient's core holds four (vol, hc + 1) tiles and up to three (vol, vol)
    if 4 * (4 * vol * (C // num_heads + 1) + 3 * vol * vol) > 227 * 1024:
        return (f"attention kernel: cuboid of {vol} rows x {C // num_heads} head channels "
                "exceeds shared memory")
    return None


def supports_axial(shape, axis: int, num_heads: int) -> bool:
    """True exactly where the axial kernels (forward, dx, all gradients,
    their dropout forms) launch on a CUDA tensor of ``shape`` (B, T, H, W, C)
    instead of raising.  ``CuboidSelfAttentionLayer`` routes by it; the route
    depends on the shape alone."""
    return _axial_refusal(tuple(shape), axis, num_heads) is None


def _check(x, axis, num_heads, forward=True):
    why = _axial_refusal(tuple(x.shape), axis, num_heads, forward)
    if why is not None:
        raise ValueError(why)
    B, T, H, W, _ = x.shape
    return B * T * H * W, (T, H, W)[axis]


def _attention_kernel(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale, eps,
                      drop=None):
    """Launch the forward on the bf16 copies of w_qkv and w_proj kept per
    parameter version, with one bf16 scratch for qkv and the head outputs;
    ``drop`` = (rate_attn, rate_proj, seed, site, bases) takes the dropout entry
    point.  x and out f32, or bf16 (the bf16 form, without dropout); the
    bias f32."""
    B, T, H, W, C = x.shape
    M, vol = _check(x, axis, num_heads)
    qkv_plan, proj_plan = attention_plan(M, C)
    form = _build.io_form("attention", x)
    if form and drop is not None:
        raise ValueError("attention kernel: the bf16 form has no dropout form")
    ln_w, ln_b, b_proj = (weights.f32(t) for t in (ln_w, ln_b, b_proj))
    _build.require("attention", [
        ("x", x, (B, T, H, W, C), x.dtype), ("ln_w", ln_w, (C,)), ("ln_b", ln_b, (C,)),
        ("w_qkv", w_qkv, (3 * C, C), w_qkv.dtype), ("bias", bias, (num_heads, vol, vol)),
        ("w_proj", w_proj, (C, C), w_proj.dtype), ("b_proj", b_proj, (C,))])
    x, ln_w, ln_b, b_proj = _build.aligned16(x, ln_w, ln_b, b_proj)
    lib = _build.load("attention", _SIGNATURES)
    _, wqkv_map = weights.linear_map(w_qkv, qkv_plan.bn, lib)
    _, wproj_map = weights.linear_map(w_proj, proj_plan.bn, lib)
    scratch = torch.empty(M * 4 * C, dtype=torch.bfloat16, device=x.device)   # qkv | attn
    out = torch.empty_like(x)
    ptrs = [_build.ptr(x), _build.ptr(ln_w), _build.ptr(ln_b), wqkv_map, _build.ptr(bias),
            wproj_map, _build.ptr(b_proj), _build.ptr(scratch), _build.ptr(scratch) + 6 * M * C,
            _build.ptr(out)]
    dims = (B, T, H, W, C, axis, num_heads, qkv_plan.bn, float(scale), float(eps))
    if drop is None:
        err = getattr(lib, "axial_attention_forward" + form)(*ptrs, *dims,
                                                             _build.stream_ptr(x.device))
        _build.check(err, "axial_attention_forward" + form)
        _build.count(fused_axial_attention, form)
    else:
        rate_attn, rate_proj, seed, site, bases = drop
        err = lib.axial_attention_dropout_forward(
            *ptrs, *dims, *_build.drop_args(seed, site, rate_attn, rate_proj, bases,
                                              x.device),
            _build.stream_ptr(x.device))
        _build.check(err, "axial_attention_dropout_forward")
        _build.count(fused_axial_attention_dropout, "")
    return out


def fused_axial_attention_dropout(x: torch.Tensor, axis: int, ln_w: torch.Tensor,
                                  ln_b: torch.Tensor, w_qkv: torch.Tensor, bias: torch.Tensor,
                                  w_proj: torch.Tensor, b_proj: torch.Tensor, num_heads: int,
                                  scale: float, eps: float = 1e-5, rate_attn: float = 0.0,
                                  rate_proj: float = 0.0, seed: int = 0,
                                  site: int = 0, bases=(0, 0)) -> torch.Tensor:
    """The layer with the dropout masks of ``(seed, site)`` from the element
    ``bases`` (multiples of 4 on the card), forward only
    (:func:`fused_axial_attention` with a seed is the differentiable form).
    CPU tensor: the plain version in f32.  CUDA tensor: the kernel, or raise.
    With both rates 0 it gives the bits of the kernel without dropout."""
    if not _build.on_card(fused_axial_attention_dropout, x):
        return axial_attention_plain(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads,
                                     scale, eps, rate_attn=rate_attn, rate_proj=rate_proj,
                                     seed=seed, site=site, bases=bases)
    return _attention_kernel(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale,
                             eps, (rate_attn, rate_proj, seed, site, bases))


def fused_axial_attention_bwd_dx(x: torch.Tensor, g: torch.Tensor, axis: int,
                                 ln_w: torch.Tensor, ln_b: torch.Tensor, w_qkv: torch.Tensor,
                                 bias: torch.Tensor, w_proj: torch.Tensor, num_heads: int,
                                 scale: float, eps: float = 1e-5) -> torch.Tensor:
    """dx of the layer.  CPU tensor: the plain version in f32.  CUDA tensor:
    the kernel (C a multiple of 64, as the forward), or raise.  x, g and dx
    f32, or bf16 (the bf16 form); the bias f32."""
    if not _build.on_card(fused_axial_attention_bwd_dx, x):
        return axial_attention_bwd_dx_plain(x, g, axis, ln_w, ln_b, w_qkv, bias, w_proj,
                                            num_heads, scale, eps)
    B, T, H, W, C = x.shape
    M, vol = _check(x, axis, num_heads, forward=False)
    form, dt = _build.io_form("attention_bwd_dx", x), x.dtype
    ln_w, ln_b = weights.f32(ln_w), weights.f32(ln_b)
    _build.require("attention_bwd_dx", [
        ("x", x, (B, T, H, W, C), dt), ("g", g, (B, T, H, W, C), dt), ("ln_w", ln_w, (C,)),
        ("ln_b", ln_b, (C,)), ("w_qkv", w_qkv, (3 * C, C), w_qkv.dtype),
        ("bias", bias, (num_heads, vol, vol)), ("w_proj", w_proj, (C, C), w_proj.dtype)])
    x, g, ln_w, ln_b = _build.aligned16(x, g, ln_w, ln_b)
    plan = axial_bwd_plan(M, C, vol, num_heads)
    lib = _build.load("attention", _SIGNATURES)
    maps = _bwd_maps(plan, w_qkv, w_proj, lib)
    bf16 = dict(dtype=torch.bfloat16, device=x.device)
    scratch = [torch.empty((M, 3 * C), **bf16), torch.empty((M, C), **bf16),   # qkv, do
               torch.empty((M, C), **bf16), torch.empty((M, 3 * C), **bf16),   # dattn, dqkv
               torch.empty((M, C), dtype=torch.float32, device=x.device)]      # dln
    dx = torch.empty_like(x)
    err = getattr(lib, "axial_attention_bwd_dx" + form)(
        _build.ptr(x), _build.ptr(g), _build.ptr(ln_w), _build.ptr(ln_b), maps[0],
        _build.ptr(bias), maps[1], maps[2], *(_build.ptr(t) for t in scratch + [dx]),
        B, T, H, W, C, axis, num_heads, plan.qkv.bn, float(scale), float(eps),
        _build.stream_ptr(x.device))
    _build.check(err, "axial_attention_bwd_dx" + form)
    _build.count(fused_axial_attention_bwd_dx, form)
    return dx


def _bwd_maps(plan, w_qkv, w_proj, lib):
    """The axial backward's bf16 weight operands: W_qkv (boxes of the QKV
    product's column tile) and the transposes of W_proj and W_qkv (boxes of
    128 rows)."""
    return (weights.linear_map(w_qkv, plan.qkv.bn, lib)[1],
            weights.linear_t_map(w_proj, plan.dattn.bn, lib)[1],
            weights.linear_t_map(w_qkv, plan.dln.bn, lib)[1])


def fused_axial_attention_bwd_full(x: torch.Tensor, g: torch.Tensor, axis: int,
                                   ln_w: torch.Tensor, ln_b: torch.Tensor, w_qkv: torch.Tensor,
                                   bias: torch.Tensor, w_proj: torch.Tensor, num_heads: int,
                                   scale: float, eps: float = 1e-5):
    """(dx, dln_w, dln_b, dw_qkv, dbias, dw_proj, db_proj) of the layer.  CPU
    tensor: the plain version in f32.  CUDA tensor: the kernel (C a multiple
    of 64, as the forward), or raise."""
    if not _build.on_card(fused_axial_attention_bwd_full, x):
        return axial_attention_bwd_full_plain(x, g, axis, ln_w, ln_b, w_qkv, bias, w_proj,
                                              num_heads, scale, eps)
    return _attention_bwd_full_kernel(x, g, axis, ln_w, ln_b, w_qkv, bias, w_proj, num_heads,
                                      scale, eps)


def fused_axial_attention_dropout_bwd_full(x: torch.Tensor, g: torch.Tensor, axis: int,
                                           ln_w: torch.Tensor, ln_b: torch.Tensor,
                                           w_qkv: torch.Tensor, bias: torch.Tensor,
                                           w_proj: torch.Tensor, num_heads: int, scale: float,
                                           eps: float = 1e-5, rate_attn: float = 0.0,
                                           rate_proj: float = 0.0, seed: int = 0, site: int = 0,
                                           bases=(0, 0)):
    """(dx, dln_w, dln_b, dw_qkv, dbias, dw_proj, db_proj) of
    :func:`fused_axial_attention_dropout`, the masks regenerated from
    ``(seed, site)``.  CPU tensor: the plain version in f32.  CUDA tensor:
    the kernel, or raise."""
    if not _build.on_card(fused_axial_attention_dropout_bwd_full, x):
        return axial_attention_bwd_full_plain(x, g, axis, ln_w, ln_b, w_qkv, bias, w_proj,
                                              num_heads, scale, eps, rate_attn=rate_attn,
                                              rate_proj=rate_proj, seed=seed, site=site,
                                              bases=bases)
    return _attention_bwd_full_kernel(x, g, axis, ln_w, ln_b, w_qkv, bias, w_proj, num_heads,
                                      scale, eps, (rate_attn, rate_proj, seed, site, bases))


def _attention_bwd_full_kernel(x, g, axis, ln_w, ln_b, w_qkv, bias, w_proj, num_heads, scale,
                               eps, drop=None):
    B, T, H, W, C = x.shape
    M, vol = _check(x, axis, num_heads, forward=False)
    _build.require("attention_bwd_full", [
        ("x", x, (B, T, H, W, C)), ("g", g, (B, T, H, W, C)), ("ln_w", ln_w, (C,)),
        ("ln_b", ln_b, (C,)), ("w_qkv", w_qkv, (3 * C, C)),
        ("bias", bias, (num_heads, vol, vol)), ("w_proj", w_proj, (C, C))])
    x, g, ln_w, ln_b = _build.aligned16(x, g, ln_w, ln_b)
    plan = axial_bwd_plan(M, C, vol, num_heads)
    ld = plan.ld
    lib = _build.load("attention", _SIGNATURES)
    maps = _bwd_maps(plan, w_qkv, w_proj, lib)
    f32 = dict(dtype=torch.float32, device=x.device)
    bf16 = dict(dtype=torch.bfloat16, device=x.device)
    scratch = [torch.empty((M, 3 * C), **bf16), torch.empty((M, C), **bf16),   # qkv, do
               torch.empty((M, C), **bf16), torch.empty((M, 3 * C), **bf16),   # dattn, dqkv
               torch.empty((M, C), **f32), torch.empty((M, C), **bf16),        # dln, attn
               torch.empty((C, ld), **bf16), torch.empty((C, ld), **bf16),     # LN^T, do^T
               torch.empty((C, ld), **bf16), torch.empty((3 * C, ld), **bf16),  # attn^T, dqkv^T
               torch.empty((plan.core_blocks, num_heads, vol, vol), **f32),
               torch.empty((-(-M // VEC_ROWS), 3, C), **f32)]
    dx, dw_qkv, dbias, dw_proj = (torch.empty_like(x), torch.empty_like(w_qkv),
                                  torch.empty_like(bias), torch.empty_like(w_proj))
    vec = torch.empty((3, C), **f32)
    args = [_build.ptr(x), _build.ptr(g), _build.ptr(ln_w), _build.ptr(ln_b), maps[0],
            _build.ptr(bias), maps[1], maps[2],
            *(_build.ptr(t) for t in scratch + [dx, dw_qkv, dbias, dw_proj, vec]),
            B, T, H, W, C, axis, num_heads, plan.qkv.bn, plan.per_block, ld,
            plan.wgrad_qkv.splits, plan.wgrad_proj.splits, float(scale), float(eps)]
    if drop is None:
        err = lib.axial_attention_bwd_full(*args, _build.stream_ptr(x.device))
        _build.check(err, "axial_attention_bwd_full")
        _build.count(fused_axial_attention_bwd_full, "")
    else:
        rate_attn, rate_proj, seed, site, bases = drop
        err = lib.axial_attention_dropout_bwd_full(
            *args, *_build.drop_args(seed, site, rate_attn, rate_proj, bases,
                                              x.device), _build.stream_ptr(x.device))
        _build.check(err, "axial_attention_dropout_bwd_full")
        _build.count(fused_axial_attention_dropout_bwd_full, "")
    return dx, vec[0], vec[1], dw_qkv, dbias, dw_proj, vec[2]


def _axial_forward(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale, eps, drop):
    if drop is not None:
        return fused_axial_attention_dropout(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj,
                                             num_heads, scale, eps, *drop)
    if not _build.on_card(fused_axial_attention, x):
        return axial_attention_plain(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj,
                                     num_heads, scale, eps)
    return _attention_kernel(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads,
                             scale, eps)


class _FusedAxialAttention(torch.autograd.Function):
    """``drop`` is None or (rate_attn, rate_proj, seed, site, bases), kept in
    ``ctx``: the backward regenerates the forward's masks from them (from a
    device seed's buffer as it is when the backward runs)."""

    @staticmethod
    def forward(ctx, x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale, eps,
                drop):
        ctx.save_for_backward(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj)
        ctx.args = (axis, num_heads, scale, eps)
        ctx.drop = drop
        return _axial_forward(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale,
                              eps, drop)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        axis, num_heads, scale, eps = ctx.args
        g = g.contiguous()
        needs = ctx.needs_input_grad
        if ctx.drop is not None or any(needs[2:8]):
            if ctx.drop is not None:
                dx, *dparams = fused_axial_attention_dropout_bwd_full(
                    x, g, axis, *params[:-1], num_heads, scale, eps, *ctx.drop)
            else:
                dx, *dparams = fused_axial_attention_bwd_full(x, g, axis, *params[:-1], num_heads,
                                                              scale, eps)
            return (dx if needs[0] else None, None,
                    *(gr if n else None for gr, n in zip(dparams, needs[2:8])),
                    None, None, None, None)
        dx = (fused_axial_attention_bwd_dx(x, g, axis, *params[:-1], num_heads, scale, eps)
              if needs[0] else None)
        return (dx,) + (None,) * 11


def fused_axial_attention(x: torch.Tensor, axis: int, ln_w: torch.Tensor, ln_b: torch.Tensor,
                          w_qkv: torch.Tensor, bias: torch.Tensor, w_proj: torch.Tensor,
                          b_proj: torch.Tensor, num_heads: int, scale: float,
                          eps: float = 1e-5, rate_attn: float = 0.0, rate_proj: float = 0.0,
                          seed: Optional[int] = None, site: int = 0,
                          bases=(0, 0)) -> torch.Tensor:
    """CPU tensor: the plain version in f32.  CUDA tensor: the kernel, or raise.
    Differentiable on both; where autograd records nothing the call goes
    straight to the forward, without the ``autograd.Function``.  With a
    ``seed`` the dropout kernels run, with the masks of ``(seed, site)`` at
    the two rates from the element ``bases``; without one the rates must be 0."""
    if seed is None:
        if rate_attn > 0.0 or rate_proj > 0.0:
            raise ValueError("fused_axial_attention: a dropout rate above 0 needs a seed")
        drop = None
    else:
        drop = (float(rate_attn), float(rate_proj), as_seed(seed), int(site),
                tuple(int(b) for b in bases))
    if _build.needs_grad(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj):
        return _FusedAxialAttention.apply(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj,
                                          num_heads, scale, eps, drop)
    return _axial_forward(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale, eps,
                          drop)


fused_axial_attention.launches = fused_axial_attention.bf16_launches = 0
fused_axial_attention_dropout.launches = 0
fused_axial_attention_dropout_bwd_full.launches = 0
fused_axial_attention_bwd_dx.launches = fused_axial_attention_bwd_dx.bf16_launches = 0
fused_axial_attention_bwd_full.launches = 0


# --------------------------------------------------------------------------- #
# General cuboid layer on cuboid_reorder's layout (B, cuboids, vol, C).

@_build.widened
def cuboid_attention_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                           w_qkv: torch.Tensor, bias: torch.Tensor, w_proj: torch.Tensor,
                           b_proj: torch.Tensor, num_heads: int, scale: float, eps: float = 1e-5,
                           mxu_dtype: Optional[torch.dtype] = None, rate_attn: float = 0.0,
                           rate_proj: float = 0.0, seed: Optional[int] = None, site: int = 0,
                           masks=None, bases=(0, 0)) -> torch.Tensor:
    """Plain version of the general cuboid layer; ``mxu_dtype`` rounds the
    matmul operands where the kernel does, ``None`` keeps f32.  Dropout as
    :func:`axial_attention_plain`, the masks (or the explicit ``masks = (m_a
    (B, cuboids, heads, vol, vol), m_p (B, cuboids, vol, C))``) on x's layout:
    ``p . m_a / (1 - rate_attn)`` before ``p . v``, ``out . m_p / (1 -
    rate_proj)`` after the projection."""
    B, nC, vol, C = x.shape
    m_a, m_p = cuboid_layer_masks(x.shape, num_heads, rate_attn, rate_proj, seed, site, masks,
                                  x.device, bases)
    q, k, v = _qkv_plain(x.float(), ln_w, ln_b, w_qkv, num_heads, eps, mxu_dtype)
    p = apply_mask(_softmax_plain(q, k, bias, scale, mxu_dtype), m_a, rate_attn)
    o = torch.einsum("bnhij,bnjhc->bnihc", _round(p, mxu_dtype), _round(v, mxu_dtype))
    out = _round(o.reshape(B, nC, vol, C), mxu_dtype) @ _round(w_proj, mxu_dtype).T + b_proj
    return apply_mask(out, m_p, rate_proj).to(x.dtype)


@_build.widened
def cuboid_attention_bwd_dx_plain(x: torch.Tensor, g: torch.Tensor, ln_w: torch.Tensor,
                                  ln_b: torch.Tensor, w_qkv: torch.Tensor, bias: torch.Tensor,
                                  w_proj: torch.Tensor, num_heads: int, scale: float,
                                  eps: float = 1e-5,
                                  mxu_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain dx of :func:`cuboid_attention_plain` for the cotangent ``g``,
    the TPU kernel's formulas (recompute, ``ds = p (dp - rowsum(dp p))``);
    ``mxu_dtype`` rounds the product operands where the kernel does."""
    B, nC, vol, C = x.shape
    hc = C // num_heads
    xr = x.float()
    q, k, v = _qkv_plain(xr, ln_w, ln_b, w_qkv, num_heads, eps, mxu_dtype)
    p = _softmax_plain(q, k, bias, scale, mxu_dtype)
    d_o = (_round(g.float(), mxu_dtype) @ _round(w_proj, mxu_dtype)).reshape(B, nC, vol,
                                                                             num_heads, hc)
    d_o = _round(d_o, mxu_dtype)
    dp = torch.einsum("bnihc,bnjhc->bnhij", d_o, _round(v, mxu_dtype))
    ds = _round(p * (dp - (dp * p).sum(dim=-1, keepdim=True)), mxu_dtype)
    dq = torch.einsum("bnhij,bnjhc->bnihc", ds, _round(k, mxu_dtype)) * scale
    dk = torch.einsum("bnhij,bnihc->bnjhc", ds, _round(q * scale, mxu_dtype))
    dv = torch.einsum("bnhij,bnihc->bnjhc", _round(p, mxu_dtype), d_o)
    dqkv = torch.stack([dq, dk, dv], dim=3).reshape(B, nC, vol, 3 * C)
    dln = _round(dqkv, mxu_dtype) @ _round(w_qkv, mxu_dtype)
    return layer_norm_bwd_plain(xr, ln_w, dln, eps).to(x.dtype)


@_build.widened
def cuboid_attention_bwd_full_plain(x: torch.Tensor, g: torch.Tensor, ln_w: torch.Tensor,
                                    ln_b: torch.Tensor, w_qkv: torch.Tensor, bias: torch.Tensor,
                                    w_proj: torch.Tensor, num_heads: int, scale: float,
                                    eps: float = 1e-5, mxu_dtype: Optional[torch.dtype] = None,
                                    rate_attn: float = 0.0, rate_proj: float = 0.0,
                                    seed: Optional[int] = None, site: int = 0, masks=None,
                                    bases=(0, 0)):
    """Plain (dx, dln_w, dln_b, dw_qkv, dbias, dw_proj, db_proj) of
    :func:`cuboid_attention_plain` for the cotangent ``g``, the TPU kernel's
    formulas: everything recomputed from x, ``dbias`` the f32 ``ds`` summed
    over every cuboid and sample; ``mxu_dtype`` rounds the product operands
    (LN(x), do, q . scale, k, v, p, the head outputs, ds, dqkv, the weights)
    where the kernel does; every sum is f32.  With dropout the masks are
    regenerated (or the explicit ``masks``): ``do = g . m_p / (1 - rate_proj)``
    feeds dWproj, dbproj and dattn; ``dp`` carries ``m_a / (1 - rate_attn)``,
    the softmax backward uses the undropped p, dv and the head outputs the
    dropped one."""
    B, nC, vol, C = x.shape
    hc = C // num_heads
    m_a, m_p = cuboid_layer_masks(x.shape, num_heads, rate_attn, rate_proj, seed, site, masks,
                                  x.device, bases)
    xr = x.float()
    do = apply_mask(g.float(), m_p, rate_proj)
    gr = _round(do, mxu_dtype)
    mu = xr.mean(dim=-1, keepdim=True)
    nhat = (xr - mu) * torch.rsqrt((xr - mu).square().mean(dim=-1, keepdim=True) + eps)
    ln = _round(nhat * ln_w + ln_b, mxu_dtype)
    q, k, v = _qkv_plain(xr, ln_w, ln_b, w_qkv, num_heads, eps, mxu_dtype)
    p = _softmax_plain(q, k, bias, scale, mxu_dtype)
    p_d = _round(apply_mask(p, m_a, rate_attn), mxu_dtype)
    o = torch.einsum("bnhij,bnjhc->bnihc", p_d, _round(v, mxu_dtype))
    d_o = _round((gr @ _round(w_proj, mxu_dtype)).reshape(B, nC, vol, num_heads, hc), mxu_dtype)
    dp = apply_mask(torch.einsum("bnihc,bnjhc->bnhij", d_o, _round(v, mxu_dtype)), m_a, rate_attn)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsr = _round(ds, mxu_dtype)
    dq = torch.einsum("bnhij,bnjhc->bnihc", dsr, _round(k, mxu_dtype)) * scale
    dk = torch.einsum("bnhij,bnihc->bnjhc", dsr, _round(q * scale, mxu_dtype))
    dv = torch.einsum("bnhij,bnihc->bnjhc", p_d, d_o)
    dqkv = _round(torch.stack([dq, dk, dv], dim=3).reshape(B, nC, vol, 3 * C), mxu_dtype)
    dln = dqkv @ _round(w_qkv, mxu_dtype)
    dx = layer_norm_bwd_plain(xr, ln_w, dln, eps).to(x.dtype)
    dw_qkv = dqkv.reshape(-1, 3 * C).T @ ln.reshape(-1, C)
    dw_proj = gr.reshape(-1, C).T @ _round(o.reshape(-1, C), mxu_dtype)
    return (dx, (dln * nhat).sum(dim=(0, 1, 2)), dln.sum(dim=(0, 1, 2)), dw_qkv,
            ds.sum(dim=(0, 1)), dw_proj, do.sum(dim=(0, 1, 2)))


# the plain versions of the dropout kernels: the same functions, with the rates
cuboid_attention_dropout_plain = cuboid_attention_plain
cuboid_attention_dropout_bwd_full_plain = cuboid_attention_bwd_full_plain


def _cuboid_refusal(n_cuboids: int, vol: int, C: int, num_heads: int) -> Optional[str]:
    """Why the general layer's kernels refuse ``n_cuboids`` cuboids of
    ``vol`` rows x C channels, or None where they all launch: the widths and
    the plans of the forward (:func:`cuboid_layer_plan`) and of the backward
    (:func:`cuboid_bwd_plan`)."""
    if C % 64 != 0 or C % num_heads != 0 or not 1 <= vol <= V4_MAX_ROWS or n_cuboids < 1:
        return (f"cuboid attention kernel: C={C} (takes multiples of 64), heads={num_heads}, "
                f"vol={vol} (takes 1..{V4_MAX_ROWS}) not supported")
    try:
        cuboid_layer_plan(n_cuboids, vol, C, num_heads)
        cuboid_bwd_plan(n_cuboids, vol, C, num_heads)
    except ValueError as e:
        return str(e)
    return None


def supports_cuboid(n_cuboids: int, vol: int, C: int, num_heads: int) -> bool:
    """True exactly where the general layer's kernels (forward, dx, all
    gradients, their dropout forms) launch on a CUDA tensor of ``n_cuboids``
    cuboids x ``vol`` rows x C channels instead of raising.
    ``CuboidSelfAttentionLayer`` routes by it; the route depends on the shape
    alone."""
    return _cuboid_refusal(n_cuboids, vol, C, num_heads) is None


def _check_cuboid(x, num_heads):
    B, nC, vol, C = x.shape
    why = _cuboid_refusal(B * nC, vol, C, num_heads)
    if why is not None:
        raise ValueError(why)
    return B * nC, vol, C


def _cuboid_kernel(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale, eps, drop=None):
    """Launch the forward on the bf16 copies of w_qkv and w_proj kept per
    parameter version, with one bf16 scratch for qkv and the head outputs
    (also the LN rows where C exceeds the LN tile); ``drop`` = (rate_attn,
    rate_proj, seed, site) takes the dropout entry point.  x and out f32, or
    bf16 (the bf16 form, without dropout); the bias f32, the parameter
    vectors read in f32 (a bf16 vector's f32 copy), the weights as their
    bf16 copies (a bf16 weight as it is)."""
    n_cuboids, vol, C = _check_cuboid(x, num_heads)
    plan = cuboid_layer_plan(n_cuboids, vol, C, num_heads)
    form = _build.io_form("cuboid_attention", x)
    if form and drop is not None:
        raise ValueError("cuboid attention kernel: the bf16 form has no dropout form")
    ln_w, ln_b, b_proj = (weights.f32(t) for t in (ln_w, ln_b, b_proj))
    _build.require("cuboid_attention", [
        ("x", x, tuple(x.shape), x.dtype), ("ln_w", ln_w, (C,)), ("ln_b", ln_b, (C,)),
        ("w_qkv", w_qkv, (3 * C, C), w_qkv.dtype), ("bias", bias, (num_heads, vol, vol)),
        ("w_proj", w_proj, (C, C), w_proj.dtype), ("b_proj", b_proj, (C,))])
    x, ln_w, ln_b, b_proj = _build.aligned16(x, ln_w, ln_b, b_proj)
    M = n_cuboids * vol
    lib = _build.load("attention", _SIGNATURES)
    _, wqkv_map = weights.linear_map(w_qkv, plan.qkv.bn, lib)
    _, wproj_map = weights.linear_map(w_proj, plan.proj.bn, lib)
    scratch = torch.empty(M * 4 * C, dtype=torch.bfloat16, device=x.device)   # qkv | attn
    out = torch.empty_like(x)
    ptrs = [_build.ptr(x), _build.ptr(ln_w), _build.ptr(ln_b), wqkv_map, _build.ptr(bias),
            wproj_map, _build.ptr(b_proj), _build.ptr(scratch), _build.ptr(scratch) + 6 * M * C,
            _build.ptr(out)]
    dims = (n_cuboids, vol, C, num_heads, plan.qkv.bn, int(plan.qkv.ln), plan.core.rows,
            plan.core.key_tiles, float(scale), float(eps))
    if drop is None:
        err = getattr(lib, "cuboid_attention_forward" + form)(*ptrs, *dims,
                                                              _build.stream_ptr(x.device))
        _build.check(err, "cuboid_attention_forward" + form)
        _build.count(fused_cuboid_attention_layer, form)
    else:
        rate_attn, rate_proj, seed, site, bases = drop
        err = lib.cuboid_attention_dropout_forward(
            *ptrs, *dims, *_build.drop_args(seed, site, rate_attn, rate_proj, bases,
                                              x.device),
            _build.stream_ptr(x.device))
        _build.check(err, "cuboid_attention_dropout_forward")
        _build.count(fused_cuboid_attention_layer_dropout, "")
    return out


def fused_cuboid_attention_layer_dropout(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                                         w_qkv: torch.Tensor, bias: torch.Tensor,
                                         w_proj: torch.Tensor, b_proj: torch.Tensor,
                                         num_heads: int, scale: float, eps: float = 1e-5,
                                         rate_attn: float = 0.0, rate_proj: float = 0.0,
                                         seed: int = 0, site: int = 0,
                                         bases=(0, 0)) -> torch.Tensor:
    """The general layer with the dropout masks of ``(seed, site)`` from the
    element ``bases`` (multiples of 4 on the card), forward
    only (:func:`fused_cuboid_attention_layer` with a seed is the
    differentiable form).  CPU tensor: the plain version in f32.  CUDA
    tensor: the kernel, or raise.  With both rates 0 it gives the bits of the
    kernel without dropout."""
    if not _build.on_card(fused_cuboid_attention_layer_dropout, x):
        return cuboid_attention_plain(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads,
                                      scale, eps, rate_attn=rate_attn, rate_proj=rate_proj,
                                      seed=seed, site=site, bases=bases)
    return _cuboid_kernel(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale, eps,
                          (rate_attn, rate_proj, seed, site, bases))


def fused_cuboid_attention_layer_bwd_dx(x: torch.Tensor, g: torch.Tensor, ln_w: torch.Tensor,
                                        ln_b: torch.Tensor, w_qkv: torch.Tensor,
                                        bias: torch.Tensor, w_proj: torch.Tensor, num_heads: int,
                                        scale: float, eps: float = 1e-5) -> torch.Tensor:
    """dx of the general cuboid layer, x and g (B, cuboids, vol, C).  CPU
    tensor: the plain version in f32.  CUDA tensor: the kernel, or raise.  x,
    g and dx f32, or bf16 (the bf16 form); the bias f32."""
    if not _build.on_card(fused_cuboid_attention_layer_bwd_dx, x):
        return cuboid_attention_bwd_dx_plain(x, g, ln_w, ln_b, w_qkv, bias, w_proj, num_heads,
                                             scale, eps)
    n_cuboids, vol, C = _check_cuboid(x, num_heads)
    form, dt = _build.io_form("cuboid_attention_bwd_dx", x), x.dtype
    ln_w, ln_b = weights.f32(ln_w), weights.f32(ln_b)
    _build.require("cuboid_attention_bwd_dx", [
        ("x", x, tuple(x.shape), dt), ("g", g, tuple(x.shape), dt), ("ln_w", ln_w, (C,)),
        ("ln_b", ln_b, (C,)), ("w_qkv", w_qkv, (3 * C, C), w_qkv.dtype),
        ("bias", bias, (num_heads, vol, vol)), ("w_proj", w_proj, (C, C), w_proj.dtype)])
    x, g, ln_w, ln_b = _build.aligned16(x, g, ln_w, ln_b)
    plan = cuboid_bwd_plan(n_cuboids, vol, C, num_heads)
    M = n_cuboids * vol
    lib = _build.load("attention", _SIGNATURES)
    maps = _bwd_maps(plan, w_qkv, w_proj, lib)
    bf16 = dict(dtype=torch.bfloat16, device=x.device)
    scratch = [torch.empty((M, 3 * C), **bf16), torch.empty((M, C), **bf16),   # qkv, do
               torch.empty((M, C), **bf16), torch.empty((M, 3 * C), **bf16),   # dattn, dqkv
               torch.empty((M, C), dtype=torch.float32, device=x.device),      # dln
               _stats(plan, x.device)]
    dx = torch.empty_like(x)
    err = getattr(lib, "cuboid_attention_bwd_dx" + form)(
        _build.ptr(x), _build.ptr(g), _build.ptr(ln_w), _build.ptr(ln_b), maps[0],
        _build.ptr(bias), maps[1], maps[2], *(_build.ptr(t) for t in scratch + [dx]),
        n_cuboids, vol, C, num_heads, plan.qkv.bn, int(plan.fused), plan.rows, float(scale),
        float(eps), _build.stream_ptr(x.device))
    _build.check(err, "cuboid_attention_bwd_dx" + form)
    _build.count(fused_cuboid_attention_layer_bwd_dx, form)
    return dx


def fused_cuboid_attention_layer_bwd_full(x: torch.Tensor, g: torch.Tensor, ln_w: torch.Tensor,
                                          ln_b: torch.Tensor, w_qkv: torch.Tensor,
                                          bias: torch.Tensor, w_proj: torch.Tensor,
                                          num_heads: int, scale: float, eps: float = 1e-5):
    """(dx, dln_w, dln_b, dw_qkv, dbias, dw_proj, db_proj) of the general
    cuboid layer, x and g (B, cuboids, vol, C).  CPU tensor: the plain
    version in f32.  CUDA tensor: the kernel, or raise."""
    if not _build.on_card(fused_cuboid_attention_layer_bwd_full, x):
        return cuboid_attention_bwd_full_plain(x, g, ln_w, ln_b, w_qkv, bias, w_proj, num_heads,
                                               scale, eps)
    return _cuboid_bwd_full_kernel(x, g, ln_w, ln_b, w_qkv, bias, w_proj, num_heads, scale, eps)


def fused_cuboid_attention_layer_dropout_bwd_full(x: torch.Tensor, g: torch.Tensor,
                                                  ln_w: torch.Tensor, ln_b: torch.Tensor,
                                                  w_qkv: torch.Tensor, bias: torch.Tensor,
                                                  w_proj: torch.Tensor, num_heads: int,
                                                  scale: float, eps: float = 1e-5,
                                                  rate_attn: float = 0.0, rate_proj: float = 0.0,
                                                  seed: int = 0, site: int = 0,
                                                  bases=(0, 0)):
    """(dx, dln_w, dln_b, dw_qkv, dbias, dw_proj, db_proj) of
    :func:`fused_cuboid_attention_layer_dropout`, the masks regenerated from
    ``(seed, site)`` and ``bases``.  CPU tensor: the plain version in f32.  CUDA tensor: the
    kernel, or raise."""
    if not _build.on_card(fused_cuboid_attention_layer_dropout_bwd_full, x):
        return cuboid_attention_bwd_full_plain(x, g, ln_w, ln_b, w_qkv, bias, w_proj, num_heads,
                                               scale, eps, rate_attn=rate_attn,
                                               rate_proj=rate_proj, seed=seed, site=site,
                                               bases=bases)
    return _cuboid_bwd_full_kernel(x, g, ln_w, ln_b, w_qkv, bias, w_proj, num_heads, scale, eps,
                                   (rate_attn, rate_proj, seed, site, bases))


def _stats(plan: CuboidBwdPlan, device) -> torch.Tensor:
    """The split core's per-row statistics (max, sum, D), or a stand-in where
    the core is fused and reads none."""
    shape = (plan.n_cuboids, plan.heads, plan.vol, 3) if not plan.fused else (4,)
    return torch.empty(shape, dtype=torch.float32, device=device)


def _cuboid_bwd_full_kernel(x, g, ln_w, ln_b, w_qkv, bias, w_proj, num_heads, scale, eps,
                            drop=None):
    n_cuboids, vol, C = _check_cuboid(x, num_heads)
    _build.require("cuboid_attention_bwd_full", [
        ("x", x, tuple(x.shape)), ("g", g, tuple(x.shape)), ("ln_w", ln_w, (C,)),
        ("ln_b", ln_b, (C,)), ("w_qkv", w_qkv, (3 * C, C)),
        ("bias", bias, (num_heads, vol, vol)), ("w_proj", w_proj, (C, C))])
    x, g, ln_w, ln_b = _build.aligned16(x, g, ln_w, ln_b)
    plan = cuboid_bwd_plan(n_cuboids, vol, C, num_heads)
    M, ld = n_cuboids * vol, plan.ld
    lib = _build.load("attention", _SIGNATURES)
    maps = _bwd_maps(plan, w_qkv, w_proj, lib)
    f32 = dict(dtype=torch.float32, device=x.device)
    bf16 = dict(dtype=torch.bfloat16, device=x.device)
    scratch = [torch.empty((M, 3 * C), **bf16), torch.empty((M, C), **bf16),   # qkv, do
               torch.empty((M, C), **bf16), torch.empty((M, 3 * C), **bf16),   # dattn, dqkv
               torch.empty((M, C), **f32), torch.empty((M, C), **bf16),        # dln, attn
               torch.empty((C, ld), **bf16), torch.empty((C, ld), **bf16),     # LN^T, do^T
               torch.empty((C, ld), **bf16), torch.empty((3 * C, ld), **bf16),  # attn^T, dqkv^T
               _stats(plan, x.device),
               torch.empty((plan.parts, num_heads, vol, vol), **f32),
               torch.empty((-(-M // VEC_ROWS), 3, C), **f32)]
    dx, dw_qkv, dbias, dw_proj = (torch.empty_like(x), torch.empty_like(w_qkv),
                                  torch.empty_like(bias), torch.empty_like(w_proj))
    vec = torch.empty((3, C), **f32)
    args = [_build.ptr(x), _build.ptr(g), _build.ptr(ln_w), _build.ptr(ln_b), maps[0],
            _build.ptr(bias), maps[1], maps[2],
            *(_build.ptr(t) for t in scratch + [dx, dw_qkv, dbias, dw_proj, vec]),
            n_cuboids, vol, C, num_heads, plan.qkv.bn, int(plan.fused), plan.rows,
            plan.per_block, ld, plan.wgrad_qkv.splits, plan.wgrad_proj.splits, float(scale),
            float(eps)]
    if drop is None:
        err = lib.cuboid_attention_bwd_full(*args, _build.stream_ptr(x.device))
        _build.check(err, "cuboid_attention_bwd_full")
        _build.count(fused_cuboid_attention_layer_bwd_full, "")
    else:
        rate_attn, rate_proj, seed, site, bases = drop
        err = lib.cuboid_attention_dropout_bwd_full(
            *args, *_build.drop_args(seed, site, rate_attn, rate_proj, bases,
                                              x.device), _build.stream_ptr(x.device))
        _build.check(err, "cuboid_attention_dropout_bwd_full")
        _build.count(fused_cuboid_attention_layer_dropout_bwd_full, "")
    return dx, vec[0], vec[1], dw_qkv, dbias, dw_proj, vec[2]


def _cuboid_forward(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale, eps, drop):
    if drop is not None:
        return fused_cuboid_attention_layer_dropout(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj,
                                                    num_heads, scale, eps, *drop)
    if not _build.on_card(fused_cuboid_attention_layer, x):
        return cuboid_attention_plain(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads,
                                      scale, eps)
    return _cuboid_kernel(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale, eps)


class _FusedCuboidAttention(torch.autograd.Function):
    """As :class:`_FusedAxialAttention`: the all-gradients kernel when a
    parameter gradient is asked for or dropout is on (training), the dx
    kernel when only dx is (guidance: the model is frozen)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale, eps, drop):
        ctx.save_for_backward(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj)
        ctx.args = (num_heads, scale, eps)
        ctx.drop = drop
        return _cuboid_forward(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale, eps,
                               drop)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        num_heads, scale, eps = ctx.args
        g = g.contiguous()
        needs = ctx.needs_input_grad
        if ctx.drop is not None or any(needs[1:7]):
            if ctx.drop is not None:
                dx, *dparams = fused_cuboid_attention_layer_dropout_bwd_full(
                    x, g, *params[:-1], num_heads, scale, eps, *ctx.drop)
            else:
                dx, *dparams = fused_cuboid_attention_layer_bwd_full(x, g, *params[:-1],
                                                                     num_heads, scale, eps)
            return (dx if needs[0] else None,
                    *(gr if n else None for gr, n in zip(dparams, needs[1:7])),
                    None, None, None, None)
        dx = (fused_cuboid_attention_layer_bwd_dx(x, g, *params[:-1], num_heads, scale, eps)
              if needs[0] else None)
        return (dx,) + (None,) * 10


def fused_cuboid_attention_layer(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                                 w_qkv: torch.Tensor, bias: torch.Tensor, w_proj: torch.Tensor,
                                 b_proj: torch.Tensor, num_heads: int, scale: float,
                                 eps: float = 1e-5, rate_attn: float = 0.0,
                                 rate_proj: float = 0.0, seed: Optional[int] = None,
                                 site: int = 0, bases=(0, 0)) -> torch.Tensor:
    """The general cuboid layer on x (B, cuboids, vol, C).  CPU tensor: the
    plain version in f32.  CUDA tensor: the kernel, or raise.  Differentiable
    on both; where autograd records nothing the call goes straight to the
    forward, without the ``autograd.Function``.  With a ``seed`` the dropout
    kernels run, with the masks of ``(seed, site)`` at the two rates from the
    element ``bases``; without one the rates must be 0."""
    if seed is None:
        if rate_attn > 0.0 or rate_proj > 0.0:
            raise ValueError("fused_cuboid_attention_layer: a dropout rate above 0 needs a seed")
        drop = None
    else:
        drop = (float(rate_attn), float(rate_proj), as_seed(seed), int(site),
                tuple(int(b) for b in bases))
    if _build.needs_grad(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj):
        return _FusedCuboidAttention.apply(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads,
                                           scale, eps, drop)
    return _cuboid_forward(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale, eps,
                           drop)


# --------------------------------------------------------------------------- #
# Grouped masked core on the head-major layout (B, heads, cuboids, vol, hc).

@_build.widened
def grouped_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                            scale: float = 1.0) -> torch.Tensor:
    """Plain version of the grouped core, f32: ``masked_softmax(q . scale .
    k^T + bias[h]) . v``; ``mask`` (cuboids, vol, vol) bool, or None.  bf16
    q, k, v (the bf16 form's plain version) are widened, the output rounded
    once."""
    s = torch.einsum("bhnic,bhnjc->bhnij", q * scale, k) + bias[None, :, None]
    p = masked_softmax(s, None if mask is None else mask[None, None])
    return torch.einsum("bhnij,bhnjc->bhnic", p, v)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero: the tensor cores' ``cvt.rna.tf32.f32``."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """f32 read as TF32 by the tensor cores: the 13 low mantissa bits dropped."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """``einsum(eq, a, b)`` from TF32 parts: one pass multiplies the rounded
    operands; three (3xTF32, as the kernel) split each operand into big =
    tf32_round(x) and small = x - big, which the tensor cores read truncated,
    and add small.big + big.small + big.big."""
    ab, bb = tf32_round(a), tf32_round(b)
    if passes == 1:
        return torch.einsum(eq, ab, bb)
    if passes != 3:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    sa, sb = _tf32_truncate(a - ab), _tf32_truncate(b - bb)
    return torch.einsum(eq, sa, bb) + torch.einsum(eq, ab, sb) + torch.einsum(eq, ab, bb)


def grouped_attention_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                           scale: float = 1.0, passes: int = 3) -> torch.Tensor:
    """The grouped core kernel's arithmetic in plain torch: the function of
    :func:`grouped_attention_plain` with both products on TF32 parts
    (``passes`` 3, as the kernel runs them; 1, a single TF32 product)."""
    s = _tf32_product("bhnic,bhnjc->bhnij", q * scale, k, passes) + bias[None, :, None]
    p = masked_softmax(s, None if mask is None else mask[None, None])
    return _tf32_product("bhnij,bhnjc->bhnic", p, v, passes)


def _check_core_hc(hc: int, what: str) -> None:
    """The grouped core kernel reads rows 16 bytes at a time (its shared
    memory does not depend on hc: 64 channels a chunk)."""
    if hc < 4 or hc % 4:
        raise ValueError(f"{what} kernel: {hc} head channels not supported (a multiple of 4)")


def _core_kernel(entry: str, q, k, v, bias, mask, scale, heads: int, nC: int,
                 dtype: torch.dtype = torch.float32):
    """Launch one of ``csrc/attention.cu``'s entry points to the grouped core
    kernel on q, k, v of q's layout (the entry point takes q's five sizes in
    order) in ``dtype``, bias (heads, vol, vol) f32 and mask (cuboids, vol,
    vol) or None."""
    vol, hc = q.shape[-2:]
    _check_core_hc(hc, entry)
    specs = [(name, t, tuple(q.shape), dtype) for name, t in (("q", q), ("k", k), ("v", v))]
    specs.append(("bias", bias, (heads, vol, vol)))
    if mask is not None:   # bool or uint8: one byte an element either way
        specs.append(("mask", mask, (nC, vol, vol),
                      torch.bool if mask.dtype == torch.bool else torch.uint8))
    _build.require(entry, specs)
    if any(t.data_ptr() % (4 * t.element_size()) for t in (q, k, v)):
        raise ValueError(f"{entry} kernel: q, k and v must be aligned to 4 elements")
    out = torch.empty_like(q)
    lib = _build.load("attention", _SIGNATURES)
    err = getattr(lib, entry)(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(bias),
        None if mask is None else _build.ptr(mask), _build.ptr(out), *q.shape, float(scale),
        _build.stream_ptr(q.device))
    _build.check(err, entry)
    return out


def _grouped_kernel(q, k, v, bias, mask, scale):
    """q, k, v and out f32, or bf16 (the bf16 form); the bias f32."""
    form = _build.io_form("cuboid_attention_grouped", q)
    out = _core_kernel("cuboid_attention_grouped" + form, q, k, v, bias, mask, scale, q.shape[1],
                       q.shape[2], q.dtype)
    _build.count(fused_cuboid_attention_grouped, form)
    return out


class _GroupedAttention(torch.autograd.Function):
    """Backward: autograd of the plain version, as the JAX package's is
    ``jax.vjp`` of its reference."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale):
        ctx.save_for_backward(q, k, v, bias, mask)
        ctx.scale = scale
        if not _build.on_card(fused_cuboid_attention_grouped, q):
            return grouped_attention_plain(q, k, v, bias, mask, scale)
        return _grouped_kernel(q, k, v, bias, mask, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask = ctx.saved_tensors
        grads = _build.plain_grads(
            lambda *a: grouped_attention_plain(*a, mask, ctx.scale), (q, k, v, bias),
            ctx.needs_input_grad[:4], g)
        return (*grads, None, None)


def fused_cuboid_attention_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                                   scale: float = 1.0) -> torch.Tensor:
    """The grouped core, q, k, v (B, heads, cuboids, vol, hc), bias (heads,
    vol, vol), mask (cuboids, vol, vol) bool or None.  CPU tensor: the plain
    version.  CUDA tensor: the kernel, or raise.  Differentiable on both.
    q, k, v and the output f32, or bf16 (the bf16 form); the bias f32."""
    if _build.needs_grad(q, k, v, bias):
        return _GroupedAttention.apply(q, k, v, bias, mask, scale)
    if not _build.on_card(fused_cuboid_attention_grouped, q):
        return grouped_attention_plain(q, k, v, bias, mask, scale)
    return _grouped_kernel(q, k, v, bias, mask, scale)


# --------------------------------------------------------------------------- #
# Round-1 core and whole layer (no model route), forward-only, f32.

def _forward_only(what: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} is forward-only, as the JAX kernel it replaces (no VJP); "
                           "call it under torch.no_grad() or on tensors without grad")


def cuboid_attention_plain_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                                scale: float = 1.0) -> torch.Tensor:
    """Plain version of the round-1 core, f32: ``masked_softmax(q . scale .
    k^T + bias[h]) . v`` on q, k, v (B, cuboids, heads, vol, hc), bias (heads,
    vol, vol), mask (cuboids, vol, vol) bool or None."""
    s = torch.einsum("bnhic,bnhjc->bnhij", q * scale, k) + bias[None, None]
    p = masked_softmax(s, None if mask is None else mask[None, :, None])
    return torch.einsum("bnhij,bnhjc->bnhic", p, v)


def fused_cuboid_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                           scale: float = 1.0) -> torch.Tensor:
    """The round-1 core on the cuboid-major layout (see
    :func:`cuboid_attention_plain_core`).  CPU tensor: the plain version.
    CUDA tensor: the kernel, or raise.  Forward-only."""
    _forward_only("fused_cuboid_attention", q, k, v, bias)
    if not _build.on_card(fused_cuboid_attention, q):
        return cuboid_attention_plain_core(q, k, v, bias, mask, scale)
    out = _core_kernel("cuboid_core_forward", q, k, v, bias, mask, scale, q.shape[2],
                       q.shape[1])
    _build.count(fused_cuboid_attention, "")
    return out


def cuboid_attention_layer_v3_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                                    w_qkv: torch.Tensor, bias: torch.Tensor,
                                    w_proj: torch.Tensor, b_proj: torch.Tensor, num_heads: int,
                                    scale: float, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of the round-1 whole layer: the general layer's function
    (:func:`cuboid_attention_plain`) in f32, without a mask or dropout."""
    return cuboid_attention_plain(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, num_heads, scale,
                                  eps)


def fused_cuboid_attention_layer_v3(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                                    w_qkv: torch.Tensor, bias: torch.Tensor,
                                    w_proj: torch.Tensor, b_proj: torch.Tensor, num_heads: int,
                                    scale: float, eps: float = 1e-5) -> torch.Tensor:
    """The round-1 whole layer, "v3" in the JAX docstring, on x (B, cuboids,
    vol, C) reordered; weights in PyTorch layout (``w_qkv`` (3C, C), ``w_proj``
    (C, C)), ``bias`` (heads, vol, vol).  CPU tensor: the plain version.  CUDA
    tensor: the kernels (four launches: the LN statistics, LN + QKV and the
    projection in 3xTF32 on the tensor cores, the grouped core between them),
    or raise.  Forward-only."""
    _forward_only("fused_cuboid_attention_layer_v3", x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj)
    if not _build.on_card(fused_cuboid_attention_layer_v3, x):
        return cuboid_attention_layer_v3_plain(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj,
                                               num_heads, scale, eps)
    B, nC, vol, C = x.shape
    if C % num_heads:
        raise ValueError(f"cuboid layer v3 kernel: C={C} not a multiple of {num_heads} heads")
    _check_core_hc(C // num_heads, "cuboid layer v3")
    _build.require("cuboid_layer_v3", [
        ("x", x, (B, nC, vol, C)), ("ln_w", ln_w, (C,)), ("ln_b", ln_b, (C,)),
        ("w_qkv", w_qkv, (3 * C, C)), ("bias", bias, (num_heads, vol, vol)),
        ("w_proj", w_proj, (C, C)), ("b_proj", b_proj, (C,))])
    M = B * nC * vol
    x, w_qkv, w_proj = _build.aligned16(x, w_qkv, w_proj)   # the products' 16-byte copies
    f32 = dict(dtype=torch.float32, device=x.device)
    stats, o = torch.empty((M, 2), **f32), torch.empty((M, C), **f32)
    qkv = torch.empty((M, 3 * C), **f32)
    out = torch.empty_like(x)
    lib = _build.load("attention", _SIGNATURES)
    err = lib.cuboid_layer_v3_forward(
        *(_build.ptr(t) for t in (x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, stats, qkv, o, out)),
        B, nC, vol, C, num_heads, float(scale), float(eps), _build.stream_ptr(x.device))
    _build.check(err, "cuboid_layer_v3_forward")
    _build.count(fused_cuboid_attention_layer_v3, "")
    return out


fused_cuboid_attention.launches = 0
fused_cuboid_attention_layer_v3.launches = 0
fused_cuboid_attention_layer.launches = fused_cuboid_attention_layer.bf16_launches = 0
fused_cuboid_attention_layer_dropout.launches = 0
fused_cuboid_attention_layer_bwd_dx.launches = 0
fused_cuboid_attention_layer_bwd_dx.bf16_launches = 0
fused_cuboid_attention_layer_bwd_full.launches = 0
fused_cuboid_attention_layer_dropout_bwd_full.launches = 0
fused_cuboid_attention_grouped.launches = fused_cuboid_attention_grouped.bf16_launches = 0
