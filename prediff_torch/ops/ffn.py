"""Fused pre-norm FFN: ``x + W2 . act(W1 . LN(x) + b1) + b2`` on (tokens, C).

``act`` is the TPU kernels' ``activation`` argument (``pallas_ffn.py``
``SUPPORTED_ACTIVATIONS``): ``"gelu"`` (exact erf, the default), ``"relu"``,
``"leaky"`` (slope 0.1) or ``"silu"`` (:data:`ACTIVATIONS`, one table,
:func:`activation` / :func:`activation_grad`, for every plain version).  Every
wrapper takes it as ``activation=`` and hands the kernel its index; any other
name raises ``ValueError``.  Each wrapper's ``launches`` counts every
activation, ``<act>_launches`` the relu / leaky / silu ones.  Below, gelu
stands for the activation.

The kernel (``csrc/ffn.cu``) replaces ``prediff_tpu/ops/pallas_ffn.py::fused_ffn``:
the hidden activation never leaves the chip, matrix products take bf16
operands with f32 accumulation on the tensor cores (the forward on TMA +
wgmma, with the bf16 weights of ``ops/weights.py``; :func:`ffn_plan` is what
it is handed, plain Python so that the CPU tests reach it).  GELU uses the exact
``erff``; the TPU kernel's A&S 7.1.26 erf differs from it by at most 4e-7.
Its input gradient (``ffn_bwd_dx`` in the same source) replaces
``pallas_ffn.py::fused_ffn_bwd_dx``, and its all-gradients backward
(``ffn_bwd_full``) replaces ``pallas_ffn.py::fused_ffn_bwd_full``: one
kernel on the same pieces (:func:`ffn_bwd_plan`; W1 and the transposed
copies W2^T and W1^T of ``ops/weights.py``) and, for all gradients, the
weight-gradient product of ``ops/wgrad.py`` on its width-major bf16 side
outputs.  With
dropout (``ffn_dropout_forward``, ``ffn_dropout_bwd_full``) they replace
``pallas_ffn.py::fused_ffn_dropout`` and ``fused_ffn_dropout_bwd_full``:
``a = gelu(h) . m1 / (1 - rate_act)``, ``out = x + (a . W2 + b2) . m2 /
(1 - rate_out)``, the masks those of ``ops/dropout.py`` for ``(seed, site)``
(tensor 0: (tokens, hidden), tensor 1: (tokens, C)), regenerated in the
backward; the seed a host integer or a device seed, read by the kernels from
its address.  Weights are in PyTorch layout: ``w1`` (hidden, C), ``w2`` (C, hidden).

:func:`fused_ffn` is differentiable.  When a parameter gradient is asked for
(training) its backward is one call of :func:`fused_ffn_bwd_full`, which
gives dx and every parameter gradient; when only dx is asked for (guidance:
the model is frozen) it is :func:`fused_ffn_bwd_dx`.  With a ``seed`` it runs
:func:`fused_ffn_dropout` and, backward, :func:`fused_ffn_dropout_bwd_full`.
"""
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import torch

from . import _build, weights, wgrad
from .dropout import apply_mask, as_seed, resolve_masks

_P, _I, _F, _DROP = _build.P, _build.I, _build.F, _build.DROP_ARGTYPES
_SIGNATURES = {"ffn_forward": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
               "ffn_bwd_dx": [_P] * 9 + [_I] * 4 + [_F, _I, _P],
               "ffn_bwd_full": [_P] * 19 + [_I] * 7 + [_F, _I, _P],
               "ffn_dropout_forward": [_P] * 8 + [_I] * 4 + [_F, _I] + _DROP + [_P],
               "ffn_dropout_bwd_full": [_P] * 19 + [_I] * 7 + [_F, _I] + _DROP + [_P],
               "ffn_forward_bf16": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
               "ffn_bwd_dx_bf16": [_P] * 9 + [_I] * 4 + [_F, _I, _P],
               **weights.MAP_SIGNATURE}
KERNEL_WIDTHS = (128, 256, 512)
_CHUNK = 64              # csrc/ffn.cu fwd::kHC, bwd::kHC: hidden units per chunk
# csrc/ffn.cu fwd: the forward's ring of weight tiles, its consumer threads
# and their registers (setmaxnreg), the SMs of an H100 and the cluster sizes
# that pack into its GPCs (3, 5 or 6 do not)
STAGES, STAGE_BYTES, CONSUMERS, CONSUMER_REGISTERS = 4, 32768, 256, 232
SMS, SPLITS = 132, (1, 2, 4, 8)
SMEM_LIMIT = 232448      # the shared memory one block may use on an H100
BWD_ROWS, BWD_LDT = 64, 64 + 8   # csrc/ffn.cu bwd::kBM, kLdT


@dataclass(frozen=True)
class FfnPlan:
    """What the forward kernel (``csrc/ffn.cu`` ``ffn_wgmma_kernel<C>``) is
    handed for M tokens of width C and ``hidden`` units: token tiles of
    ``rows`` rows (128; 64 at C = 512, where the two warpgroups split the
    columns), the hidden dimension in chunks of 64 split over a cluster of
    ``splits`` blocks, and what that costs in shared memory and registers."""
    M: int
    C: int
    hidden: int
    rows: int
    splits: int

    @property
    def split_cols(self) -> bool:
        return self.C == 512

    @property
    def row_tiles(self) -> int:
        return -(-self.M // self.rows)

    @property
    def chunks(self) -> int:
        return self.hidden // _CHUNK

    def chunk_range(self, rank: int) -> range:
        """The hidden chunks that block ``rank`` of a cluster adds."""
        return range(rank * self.chunks // self.splits, (rank + 1) * self.chunks // self.splits)

    def warpgroup_tile(self, wg: int):
        """(rows, h columns within a chunk, output columns) of consumer warpgroup ``wg``."""
        if self.split_cols:
            return (range(0, 64), range(32 * wg, 32 * wg + 32),
                    range(self.C // 2 * wg, self.C // 2 * (wg + 1)))
        return range(64 * wg, 64 * wg + 64), range(0, 64), range(0, self.C)

    @property
    def item_k(self) -> int:
        """W1c columns / W2c rows of one ring item (the W2 map's box height)."""
        return min(self.C, 256)

    @property
    def smem_bytes(self) -> int:
        """Alignment, the bf16 LN tile, the h tile(s) and the ring."""
        return 1024 + self.rows * self.C * 2 + 16384 + STAGES * STAGE_BYTES

    @property
    def accumulators(self) -> int:
        """f32 registers a consumer thread holds: out (64 x its columns) and h."""
        out_cols = self.C // 2 if self.split_cols else self.C
        h_cols = 32 if self.split_cols else 64
        return (64 * out_cols + 64 * h_cols) // 128

    @property
    def partial_bytes(self) -> int:
        """The f32 partial a block parks in its ring for the cluster's sum."""
        out_cols = self.C // 2 if self.split_cols else self.C
        return CONSUMERS * (64 * out_cols // 128) * 4


@lru_cache(maxsize=None)
def ffn_plan(M: int, C: int, hidden: int) -> FfnPlan:
    """The most splits of ``SPLITS`` (at most one per chunk) that keep every
    block in one wave over the ``SMS`` SMs."""
    _check_widths(M, C, hidden)
    rows = 64 if C == 512 else 128
    row_tiles = -(-M // rows)
    chunks = hidden // _CHUNK
    splits = max(s for s in SPLITS if s == 1 or (s <= chunks and row_tiles * s <= SMS))
    return FfnPlan(M, C, hidden, rows, splits)


@dataclass(frozen=True)
class FfnBwdPlan:
    """What the backward kernel (``csrc/ffn.cu`` ``ffn_bwd_kernel<C>``) is
    handed for M tokens of width C and ``hidden`` units: 64-row token tiles,
    the hidden dimension in chunks of 64 split over a cluster of ``splits``
    blocks; each consumer warpgroup takes 32 columns of h, da and dh in a
    chunk and half of dln's columns; after the products rank r adds the
    cluster's dln partials for rows ``rank_rows(r)`` and applies the
    LayerNorm backward."""
    M: int
    C: int
    hidden: int
    splits: int

    @property
    def row_tiles(self) -> int:
        return -(-self.M // BWD_ROWS)

    @property
    def chunks(self) -> int:
        return self.hidden // _CHUNK

    def chunk_range(self, rank: int) -> range:
        return range(rank * self.chunks // self.splits, (rank + 1) * self.chunks // self.splits)

    def rank_rows(self, rank: int) -> range:
        """The rows of a tile whose dx rank ``rank`` writes."""
        n = BWD_ROWS // self.splits
        return range(rank * n, (rank + 1) * n)

    def warpgroup_tile(self, wg: int):
        """(columns of h / da / dh within a chunk, columns of dln) of warpgroup ``wg``."""
        return range(32 * wg, 32 * wg + 32), range(self.C // 2 * wg, self.C // 2 * (wg + 1))

    @property
    def item_k(self) -> int:
        return min(self.C, 256)

    @property
    def stages(self) -> int:
        return 2 if self.C == 512 else 4

    @property
    def smem_bytes(self) -> int:
        """Alignment, the LN(x) and do tiles, the dh tile, the ring, the
        transposed staging tiles of gelu(h) and dh."""
        return (1024 + 2 * BWD_ROWS * self.C * 2 + BWD_ROWS * _CHUNK * 2
                + self.stages * STAGE_BYTES + 2 * _CHUNK * BWD_LDT * 2)

    @property
    def epilogue_bytes(self) -> int:
        """The rank's f32 dln partial and the warps' column sums, laid over
        the tiles and the ring once the products are done."""
        return BWD_ROWS * self.C * 4 + 8 * 2 * self.C * 4

    @property
    def accumulators(self) -> int:
        """f32 registers a consumer thread holds: dln (64 x C / 2), h and da (64 x 32 each)."""
        return (64 * self.C // 2 + 2 * 64 * 32) // 128


@lru_cache(maxsize=None)
def ffn_bwd_plan(M: int, C: int, hidden: int) -> FfnBwdPlan:
    """The most splits of ``SPLITS`` (at most one per chunk) that keep every
    block in one wave over the ``SMS`` SMs."""
    _check_widths(M, C, hidden)
    row_tiles = -(-M // BWD_ROWS)
    chunks = hidden // _CHUNK
    splits = max(s for s in SPLITS if s == 1 or (s <= chunks and row_tiles * s <= SMS))
    return FfnBwdPlan(M, C, hidden, splits)


def _round(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None else t.to(dtype).float()


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """Two-pass LayerNorm over the last axis, the kernels' arithmetic."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * weight + bias


def layer_norm_bwd_plain(x: torch.Tensor, weight: torch.Tensor, dln: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """dx of :func:`layer_norm_plain` for the output cotangent ``dln``."""
    mu = x.mean(dim=-1, keepdim=True)
    rs = torch.rsqrt((x - mu).square().mean(dim=-1, keepdim=True) + eps)
    nhat = (x - mu) * rs
    dnhat = dln * weight
    return rs * (dnhat - dnhat.mean(dim=-1, keepdim=True)
                 - nhat * (dnhat * nhat).mean(dim=-1, keepdim=True))


def gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d gelu_erf(h) / dh = Phi(h) + h phi(h)."""
    return (0.5 * (1.0 + torch.erf(h * 0.5 ** 0.5))
            + h * torch.exp(-0.5 * h * h) * (2.0 * torch.pi) ** -0.5)


# the kernels' activations, in the order of csrc/ffn.cu's enum Act
ACTIVATIONS = ("gelu", "relu", "leaky", "silu")


def activation_index(name: str) -> int:
    """The kernels' index of an activation; any name but :data:`ACTIVATIONS` raises."""
    if name not in ACTIVATIONS:
        raise ValueError(f"ffn kernel: activation {name!r} not supported ({ACTIVATIONS})")
    return ACTIVATIONS.index(name)


def activation(h: torch.Tensor, name: str = "gelu") -> torch.Tensor:
    """act(h), the TPU kernels' ``_apply_activation``."""
    activation_index(name)
    if name == "gelu":
        return torch.nn.functional.gelu(h)
    if name == "relu":
        return torch.clamp_min(h, 0.0)
    if name == "leaky":
        return torch.where(h >= 0.0, h, 0.1 * h)
    return h * torch.sigmoid(h)


def activation_grad(h: torch.Tensor, name: str = "gelu") -> torch.Tensor:
    """act'(h), the TPU kernels' ``_apply_activation_grad``: at 0 relu' = 0,
    leaky' = 1."""
    activation_index(name)
    if name == "gelu":
        return gelu_grad(h)
    if name == "relu":
        return (h > 0.0).to(h.dtype)
    if name == "leaky":
        return torch.where(h >= 0.0, 1.0, 0.1).to(h.dtype)
    s = torch.sigmoid(h)
    return s * (1.0 + h * (1.0 - s))


_act = activation   # the plain versions' ``activation`` argument shadows the function


@_build.widened
def ffn_dropout_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                      w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                      eps: float = 1e-5, rate_act: float = 0.0, rate_out: float = 0.0,
                      seed: Optional[int] = None, site: int = 0, masks=None,
                      mxu_dtype: Optional[torch.dtype] = None, bases=(0, 0),
                      activation: str = "gelu") -> torch.Tensor:
    """Plain PyTorch version with dropout on act(h) (``rate_act``) and on the
    output before the residual (``rate_out``).  The masks are those of
    ``(seed, site)`` from the element ``bases`` (``ops/dropout.py``), or the
    explicit ``masks = (m1 (tokens, hidden), m2 (tokens, C))`` of 0/1 values.  ``mxu_dtype=torch.bfloat16`` rounds the
    matmul operands (LN output, weights, the dropped hidden) where the kernel
    does; ``None`` keeps f32 throughout."""
    M, C = x.shape
    m1, m2 = resolve_masks((rate_act, rate_out), ((M, w1.shape[0]), (M, C)), seed, site, masks,
                           x.device, bases)
    xf = x.float()
    ln = layer_norm_plain(xf, ln_w, ln_b, eps)
    h = _round(ln, mxu_dtype) @ _round(w1, mxu_dtype).T + b1
    a = apply_mask(_act(h, activation), m1, rate_act)
    out = apply_mask(_round(a, mxu_dtype) @ _round(w2, mxu_dtype).T + b2, m2, rate_out)
    return (xf + out).to(x.dtype)


def ffn_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
              b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, eps: float = 1e-5,
              mxu_dtype: Optional[torch.dtype] = None, activation: str = "gelu") -> torch.Tensor:
    """Plain PyTorch version without dropout."""
    return ffn_dropout_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, mxu_dtype=mxu_dtype,
                             activation=activation)


@_build.widened
def ffn_bwd_dx_plain(x: torch.Tensor, g: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, eps: float = 1e-5,
                     mxu_dtype: Optional[torch.dtype] = None,
                     activation: str = "gelu") -> torch.Tensor:
    """Plain dx of :func:`ffn_plain` for the cotangent ``g``, the TPU kernel's
    formulas; ``mxu_dtype`` rounds LN(x), g, the weights and dh as the
    kernel does."""
    xf, gf = x.float(), g.float()
    ln = layer_norm_plain(xf, ln_w, ln_b, eps)
    h = _round(ln, mxu_dtype) @ _round(w1, mxu_dtype).T + b1
    da = _round(gf, mxu_dtype) @ _round(w2, mxu_dtype)
    dh = da * activation_grad(h, activation)
    dln = _round(dh, mxu_dtype) @ _round(w1, mxu_dtype)
    return (gf + layer_norm_bwd_plain(xf, ln_w, dln, eps)).to(x.dtype)


@_build.widened
def ffn_dropout_bwd_full_plain(x: torch.Tensor, g: torch.Tensor, ln_w: torch.Tensor,
                               ln_b: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                               w2: torch.Tensor, eps: float = 1e-5, rate_act: float = 0.0,
                               rate_out: float = 0.0, seed: Optional[int] = None, site: int = 0,
                               masks=None, mxu_dtype: Optional[torch.dtype] = None,
                               bases=(0, 0), activation: str = "gelu"):
    """Plain (dx, dln_w, dln_b, dw1, db1, dw2, db2) of
    :func:`ffn_dropout_plain` for the cotangent ``g``, the TPU kernel's
    formulas: everything recomputed from x, the masks regenerated (or the
    explicit ``masks``).  ``do = g . m2 / (1 - rate_out)`` feeds dW2, db2 and
    da, while the residual's share of dx is the unmasked g; the activation and
    ``dz = da . gelu'(h)`` both carry ``m1 / (1 - rate_act)``.  ``mxu_dtype``
    rounds LN(x), do, the weights, the dropped gelu(h) and dz before the
    products, as the kernel does; every sum is f32."""
    M, C = x.shape
    m1, m2 = resolve_masks((rate_act, rate_out), ((M, w1.shape[0]), (M, C)), seed, site, masks,
                           x.device, bases)
    xf, gf = x.float(), g.float()
    mu = xf.mean(dim=-1, keepdim=True)
    nhat = (xf - mu) * torch.rsqrt((xf - mu).square().mean(dim=-1, keepdim=True) + eps)
    ln = _round(nhat * ln_w + ln_b, mxu_dtype)
    do = apply_mask(gf, m2, rate_out)
    dor = _round(do, mxu_dtype)
    h = ln @ _round(w1, mxu_dtype).T + b1
    da = dor @ _round(w2, mxu_dtype)
    dz = apply_mask(da * activation_grad(h, activation), m1, rate_act)
    dzr = _round(dz, mxu_dtype)
    dln = dzr @ _round(w1, mxu_dtype)
    dx = (gf + layer_norm_bwd_plain(xf, ln_w, dln, eps)).to(x.dtype)
    dw2 = dor.T @ _round(apply_mask(_act(h, activation), m1, rate_act), mxu_dtype)
    dw1 = dzr.T @ ln
    return (dx, (dln * nhat).sum(dim=0), dln.sum(dim=0), dw1, dz.sum(dim=0), dw2,
            do.sum(dim=0))


def ffn_bwd_full_plain(x: torch.Tensor, g: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                       w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, eps: float = 1e-5,
                       mxu_dtype: Optional[torch.dtype] = None, activation: str = "gelu"):
    """Plain (dx, dln_w, dln_b, dw1, db1, dw2, db2) of :func:`ffn_plain`."""
    return ffn_dropout_bwd_full_plain(x, g, ln_w, ln_b, w1, b1, w2, eps, mxu_dtype=mxu_dtype,
                                      activation=activation)


def supports_shape(M: int, C: int, hidden: int) -> bool:
    """True exactly where the FFN kernels (forward, dx, all gradients, their
    dropout forms) launch on a CUDA tensor instead of raising: C in
    ``KERNEL_WIDTHS``, hidden a positive multiple of 64.  ``PositionwiseFFN``
    routes by it, as the JAX package's FFN routes by
    ``pallas_ffn.supports_shape``; the route depends on the shape alone."""
    return M >= 1 and C in KERNEL_WIDTHS and hidden >= _CHUNK and hidden % _CHUNK == 0


def _check_widths(M: int, C: int, hidden: int) -> None:
    if not supports_shape(M, C, hidden):
        raise ValueError(f"ffn kernel: M={M}, C={C} (takes {KERNEL_WIDTHS}), hidden={hidden} "
                         "(takes multiples of 64) not supported")


def _ffn_kernel(x, ln_w, ln_b, w1, b1, w2, b2, eps, drop=None, activation="gelu"):
    """Launch the forward (one launch, no workspace) on the bf16 copies of
    w1 and w2 kept per parameter version; ``drop`` = (rate_act, rate_out,
    seed, site, bases) takes the dropout entry point.  x and out f32, or bf16 (the
    bf16 form, without dropout)."""
    act = activation_index(activation)
    M, C = x.shape
    hidden = w1.shape[0]
    plan = ffn_plan(M, C, hidden)
    form = _build.io_form("ffn", x)
    if form and drop is not None:
        raise ValueError("ffn kernel: the bf16 form has no dropout form")
    ln_w, ln_b, b1, b2 = (weights.f32(t) for t in (ln_w, ln_b, b1, b2))
    _build.require("ffn", [("x", x, (M, C), x.dtype), ("ln_w", ln_w, (C,)), ("ln_b", ln_b, (C,)),
                           ("w1", w1, (hidden, C), w1.dtype), ("b1", b1, (hidden,)),
                           ("w2", w2, (C, hidden), w2.dtype), ("b2", b2, (C,))])
    x, ln_w, ln_b, b1, b2 = _build.aligned16(x, ln_w, ln_b, b1, b2)
    lib = _build.load("ffn", _SIGNATURES)
    _, w1_map = weights.linear_map(w1, 64, lib)
    _, w2_map = weights.linear_map(w2, plan.item_k, lib)
    out = torch.empty_like(x)
    args = [_build.ptr(x), _build.ptr(ln_w), _build.ptr(ln_b), w1_map, _build.ptr(b1), w2_map,
            _build.ptr(b2), _build.ptr(out), M, C, hidden, plan.splits, float(eps), act]
    if drop is None:
        err = getattr(lib, "ffn_forward" + form)(*args, _build.stream_ptr(x.device))
        _build.check(err, "ffn_forward" + form)
        _build.count(fused_ffn, form, activation)
    else:
        rate_act, rate_out, seed, site, bases = drop
        err = lib.ffn_dropout_forward(*args, *_build.drop_args(seed, site, rate_act, rate_out,
                                                               bases, x.device),
                                      _build.stream_ptr(x.device))
        _build.check(err, "ffn_dropout_forward")
        _build.count(fused_ffn_dropout, "", activation)
    return out


def fused_ffn_dropout(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
                      b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, eps: float = 1e-5,
                      rate_act: float = 0.0, rate_out: float = 0.0, seed: int = 0,
                      site: int = 0, bases=(0, 0), activation: str = "gelu") -> torch.Tensor:
    """The fused FFN with the dropout masks of ``(seed, site)`` from the
    element ``bases`` (multiples of 4 on the card), forward only
    (:func:`fused_ffn` with a seed is the differentiable form).  CPU tensor:
    the plain version in f32.  CUDA tensor: the kernel, or raise.  With both
    rates 0 it gives the bits of the kernel without dropout."""
    if not _build.on_card(fused_ffn_dropout, x):
        return ffn_dropout_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, rate_act, rate_out, seed,
                                 site, bases=bases, activation=activation)
    return _ffn_kernel(x, ln_w, ln_b, w1, b1, w2, b2, eps,
                       (rate_act, rate_out, seed, site, bases), activation)


def _bwd_maps(w1, w2, C, lib):
    """The backward's bf16 weight operands (their tensor maps): W1 (boxes of
    64 rows, the forward's), W2^T (64 rows) and W1^T (min(C, 256) rows)."""
    return (weights.linear_map(w1, 64, lib)[1], weights.linear_t_map(w2, 64, lib)[1],
            weights.linear_t_map(w1, min(C, 256), lib)[1])


def fused_ffn_bwd_dx(x: torch.Tensor, g: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     eps: float = 1e-5, activation: str = "gelu") -> torch.Tensor:
    """dx of the fused FFN.  CPU tensor: the plain version in f32.  CUDA
    tensor: the kernel (C in ``KERNEL_WIDTHS``, hidden a multiple of 64, as
    the forward), or raise.  x, g and dx f32, or bf16 (the bf16 form)."""
    if not _build.on_card(fused_ffn_bwd_dx, x):
        return ffn_bwd_dx_plain(x, g, ln_w, ln_b, w1, b1, w2, eps, activation=activation)
    act = activation_index(activation)
    M, C = x.shape
    hidden = w1.shape[0]
    plan = ffn_bwd_plan(M, C, hidden)
    form, dt = _build.io_form("ffn_bwd_dx", x), x.dtype
    ln_w, ln_b, b1 = (weights.f32(t) for t in (ln_w, ln_b, b1))
    _build.require("ffn_bwd_dx", [
        ("x", x, (M, C), dt), ("g", g, (M, C), dt), ("ln_w", ln_w, (C,)), ("ln_b", ln_b, (C,)),
        ("w1", w1, (hidden, C), w1.dtype), ("b1", b1, (hidden,)),
        ("w2", w2, (C, hidden), w2.dtype)])
    x, g, ln_w, ln_b, b1 = _build.aligned16(x, g, ln_w, ln_b, b1)
    lib = _build.load("ffn", _SIGNATURES)
    w1_map, w2t_map, w1t_map = _bwd_maps(w1, w2, C, lib)
    dx = torch.empty_like(x)
    err = getattr(lib, "ffn_bwd_dx" + form)(
        _build.ptr(x), _build.ptr(g), _build.ptr(ln_w), _build.ptr(ln_b), w1_map, _build.ptr(b1),
        w2t_map, w1t_map, _build.ptr(dx), M, C, hidden, plan.splits, float(eps), act,
        _build.stream_ptr(x.device))
    _build.check(err, "ffn_bwd_dx" + form)
    _build.count(fused_ffn_bwd_dx, form, activation)
    return dx


def fused_ffn_bwd_full(x: torch.Tensor, g: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                       w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, eps: float = 1e-5,
                       activation: str = "gelu"):
    """(dx, dln_w, dln_b, dw1, db1, dw2, db2) of the fused FFN.  CPU tensor:
    the plain version in f32.  CUDA tensor: the kernel (widths as the
    forward), or raise."""
    if not _build.on_card(fused_ffn_bwd_full, x):
        return ffn_bwd_full_plain(x, g, ln_w, ln_b, w1, b1, w2, eps, activation=activation)
    return _ffn_bwd_full_kernel(x, g, ln_w, ln_b, w1, b1, w2, eps, activation=activation)


def fused_ffn_dropout_bwd_full(x: torch.Tensor, g: torch.Tensor, ln_w: torch.Tensor,
                               ln_b: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                               w2: torch.Tensor, eps: float = 1e-5, rate_act: float = 0.0,
                               rate_out: float = 0.0, seed: int = 0, site: int = 0,
                               bases=(0, 0), activation: str = "gelu"):
    """(dx, dln_w, dln_b, dw1, db1, dw2, db2) of :func:`fused_ffn_dropout`, the
    masks regenerated from ``(seed, site)`` and ``bases``.  CPU tensor: the
    plain version in f32.  CUDA tensor: the kernel, or raise."""
    if not _build.on_card(fused_ffn_dropout_bwd_full, x):
        return ffn_dropout_bwd_full_plain(x, g, ln_w, ln_b, w1, b1, w2, eps, rate_act, rate_out,
                                          seed, site, bases=bases, activation=activation)
    return _ffn_bwd_full_kernel(x, g, ln_w, ln_b, w1, b1, w2, eps,
                                (rate_act, rate_out, seed, site, bases), activation)


def _ffn_bwd_full_kernel(x, g, ln_w, ln_b, w1, b1, w2, eps, drop=None, activation="gelu"):
    """Launch the all-gradients backward (``drop`` = (rate_act, rate_out,
    seed, site, bases): its dropout entry point): the kernel, the ordered sums of
    the vector gradients' partials, the two weight-gradient products."""
    act = activation_index(activation)
    M, C = x.shape
    hidden = w1.shape[0]
    plan = ffn_bwd_plan(M, C, hidden)
    _build.require("ffn_bwd_full", [
        ("x", x, (M, C)), ("g", g, (M, C)), ("ln_w", ln_w, (C,)), ("ln_b", ln_b, (C,)),
        ("w1", w1, (hidden, C)), ("b1", b1, (hidden,)), ("w2", w2, (C, hidden))])
    x, g, ln_w, ln_b, b1 = _build.aligned16(x, g, ln_w, ln_b, b1)
    lib = _build.load("ffn", _SIGNATURES)
    maps = _bwd_maps(w1, w2, C, lib)
    ld = wgrad.token_ld(M)
    f32 = dict(dtype=torch.float32, device=x.device)
    bf16 = dict(dtype=torch.bfloat16, device=x.device)
    side = [torch.empty((C, ld), **bf16), torch.empty((C, ld), **bf16),            # LN^T, do^T
            torch.empty((hidden, ld), **bf16), torch.empty((hidden, ld), **bf16)]  # a^T, dh^T
    parts = [torch.empty((plan.row_tiles * plan.splits, 3, C), **f32),
             torch.empty((plan.row_tiles, hidden), **f32)]
    dx, dw1, db1, dw2 = (torch.empty_like(x), torch.empty_like(w1), torch.empty_like(b1),
                         torch.empty_like(w2))
    vec = torch.empty((3, C), **f32)
    args = [_build.ptr(x), _build.ptr(g), _build.ptr(ln_w), _build.ptr(ln_b), maps[0],
            _build.ptr(b1), maps[1], maps[2],
            *(_build.ptr(t) for t in side + parts + [dx, dw1, db1, dw2, vec]),
            M, C, hidden, ld, plan.splits, wgrad.wgrad_plan(hidden, C, M).splits,
            wgrad.wgrad_plan(C, hidden, M).splits, float(eps), act]
    if drop is None:
        err = lib.ffn_bwd_full(*args, _build.stream_ptr(x.device))
        _build.check(err, "ffn_bwd_full")
        _build.count(fused_ffn_bwd_full, "", activation)
    else:
        rate_act, rate_out, seed, site, bases = drop
        err = lib.ffn_dropout_bwd_full(*args, *_build.drop_args(seed, site, rate_act, rate_out,
                                                                bases, x.device),
                                       _build.stream_ptr(x.device))
        _build.check(err, "ffn_dropout_bwd_full")
        _build.count(fused_ffn_dropout_bwd_full, "", activation)
    return dx, vec[0], vec[1], dw1, db1, dw2, vec[2]


def _ffn_forward(x, ln_w, ln_b, w1, b1, w2, b2, eps, drop, activation):
    if drop is not None:
        return fused_ffn_dropout(x, ln_w, ln_b, w1, b1, w2, b2, eps, *drop,
                                 activation=activation)
    if not _build.on_card(fused_ffn, x):
        return ffn_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps, activation=activation)
    return _ffn_kernel(x, ln_w, ln_b, w1, b1, w2, b2, eps, activation=activation)


class _FusedFFN(torch.autograd.Function):
    """``drop`` is None or (rate_act, rate_out, seed, site, bases), kept in
    ``ctx``: the backward regenerates the forward's masks from them (from a
    device seed's buffer as it is when the backward runs)."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, w2, b2, eps, drop, activation):
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1, w2, b2)
        ctx.eps, ctx.drop, ctx.activation = eps, drop, activation
        return _ffn_forward(x, ln_w, ln_b, w1, b1, w2, b2, eps, drop, activation)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        g = g.contiguous()
        needs = ctx.needs_input_grad
        if ctx.drop is not None or any(needs[1:7]):
            if ctx.drop is not None:
                grads = fused_ffn_dropout_bwd_full(x, g, *params[:-1], ctx.eps, *ctx.drop,
                                                   activation=ctx.activation)
            else:
                grads = fused_ffn_bwd_full(x, g, *params[:-1], ctx.eps, activation=ctx.activation)
            return (*(gr if n else None for gr, n in zip(grads, needs)), None, None, None)
        dx = (fused_ffn_bwd_dx(x, g, *params[:-1], ctx.eps, activation=ctx.activation)
              if needs[0] else None)
        return (dx,) + (None,) * 9


def fused_ffn(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
              b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, eps: float = 1e-5,
              rate_act: float = 0.0, rate_out: float = 0.0, seed: Optional[int] = None,
              site: int = 0, bases=(0, 0), activation: str = "gelu") -> torch.Tensor:
    """CPU tensor: the plain version in f32.  CUDA tensor: the kernel, or raise.
    Differentiable on both; where autograd records nothing the call goes
    straight to the forward, without the ``autograd.Function``.  With a
    ``seed`` the dropout kernels run, with the masks of ``(seed, site)`` at
    the two rates from the element ``bases``; without one the rates must be 0.
    ``activation``: one of :data:`ACTIVATIONS`, else ``ValueError``."""
    activation_index(activation)
    if seed is None:
        if rate_act > 0.0 or rate_out > 0.0:
            raise ValueError("fused_ffn: a dropout rate above 0 needs a seed")
        drop = None
    else:
        drop = (float(rate_act), float(rate_out), as_seed(seed), int(site),
                tuple(int(b) for b in bases))
    if _build.needs_grad(x, ln_w, ln_b, w1, b1, w2, b2):
        return _FusedFFN.apply(x, ln_w, ln_b, w1, b1, w2, b2, eps, drop, activation)
    return _ffn_forward(x, ln_w, ln_b, w1, b1, w2, b2, eps, drop, activation)


fused_ffn.launches = fused_ffn.bf16_launches = 0
fused_ffn_dropout.launches = 0
fused_ffn_dropout_bwd_full.launches = 0
fused_ffn_bwd_dx.launches = fused_ffn_bwd_dx.bf16_launches = 0
fused_ffn_bwd_full.launches = 0
for _w in (fused_ffn, fused_ffn_dropout, fused_ffn_dropout_bwd_full, fused_ffn_bwd_dx,
           fused_ffn_bwd_full):
    for _a in ACTIVATIONS[1:]:
        setattr(_w, f"{_a}_launches", 0)
