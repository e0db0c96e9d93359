"""Dropout masks from a counter-based generator, the same on the CPU and in
the kernels.

The TPU kernels (``prediff_tpu/ops/pallas_ffn.py::_keep_mask``) draw their
masks from a stateful per-core generator seeded per grid cell, which ties the
mask to the tiling.  Here a mask is a pure function of logical coordinates:

    keep(seed, site, tensor, element)
        = philox4x32_10(key = the seed's two words,
                        counter = (element // 4 low, element // 4 high, tensor, site)
                        )[element % 4] >= thr
    thr = min(round(rate * 2**32), 2**32 - 1)

``element`` is the row-major index in the logical tensor of the whole
batch, ``tensor`` numbers the masks of one module call (0: the FFN's hidden
activation or the attention weights, 1: the module's output) and ``site``
numbers the module calls of one forward (a cuboid layer with global vectors
takes two: its local weights and output, then the global vectors' weights and
projected output).  On several ranks a rank holds rows
``first_row ..`` of the batch, and every mask tensor has the batch as its
leading factor, so the rank's local element ``e`` is the element ``base + e``
with ``base = first_row * (elements per batch row)``: the ``base`` of
:func:`keep_mask` and of the dropout kernels (:meth:`DropoutStream.bases`),
so each rank draws its rows of the one-process masks.  Base 0 is one
process.  Kept values are divided by ``1 - rate``.  A forward kernel and its
backward, whatever their grids, regenerate the same mask from
``(seed, site)``; nothing is stored.  ``csrc/philox.cuh`` is the same
function on the card: integer arithmetic, so the two agree bit for bit.

A seed is a host integer or a *device seed*: a one-element int64 tensor
holding the seed's 64 bits, its two uint32 words low first
(:func:`device_seed`).  The kernels read a device seed from its address when
they start (one 8-byte load), so a captured CUDA graph that launches them
draws the masks of whatever seed the buffer holds at each replay; the plain
versions here compute the same words with tensor arithmetic.  A device seed
gives the masks of the integer it holds, bit for bit.
"""
from typing import Optional, Sequence, Tuple, Union

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # key increments (Weyl sequence)
_MASK32 = 0xFFFFFFFF


def threshold(rate: float) -> int:
    """The uint32 a draw must reach to be kept (the TPU kernels' rule)."""
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def check_rates(*rates: float) -> None:
    if not all(0.0 <= r < 1.0 for r in rates):
        raise ValueError(f"dropout rates {rates} must lie in [0, 1)")


Seed = Union[int, torch.Tensor]


def device_seed(seed: int, device=None) -> torch.Tensor:
    """A device seed holding the integer ``seed`` (mod 2**64)."""
    return torch.tensor([signed64(seed)], dtype=torch.int64, device=device)


def signed64(seed: int) -> int:
    """``seed`` mod 2**64 as the int64 of the same bits: what a device seed
    holds (``fill_`` / ``copy_`` it into one)."""
    seed = int(seed) % 2 ** 64
    return seed - 2 ** 64 if seed >= 2 ** 63 else seed


def as_seed(seed: Seed) -> Seed:
    """A seed as the dropout paths keep it: an integer mod 2**64, or a device
    seed as it is (a one-element int64 tensor; anything else raises)."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise ValueError(f"a device seed is a one-element int64 tensor, got {seed.dtype} "
                             f"{tuple(seed.shape)}")
        return seed
    return int(seed) % 2 ** 64


def seed_words(seed: Seed):
    """The two 32-bit key words of a seed (low, high): integers, or 0-dim
    int64 tensors on a device seed's device."""
    if isinstance(seed, torch.Tensor):
        s = as_seed(seed).reshape(())
        return s & _MASK32, (s >> 32) & _MASK32
    seed = int(seed) % 2 ** 64
    return seed & _MASK32, seed >> 32


def _mulhilo(m: int, a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of ``m * a`` for uint32 values held in int64,
    through 16-bit halves so that no int64 product overflows."""
    ah, al = a >> 16, a & 0xFFFF
    hi_part, lo_part = ah * m, al * m                 # both below 2**48
    hi = (hi_part + (lo_part >> 16)) >> 16
    lo = (((hi_part & 0xFFFF) << 16) + lo_part) & _MASK32
    return hi, lo


def philox4x32(key: Tuple[int, int], counter: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors of uint32 values:
    four counter words in, four random words out."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def random_bits(seed: Seed, site: int, tensor: int, n: int, device=None,
                base: int = 0) -> torch.Tensor:
    """The ``n`` uint32 draws (as int64) of the stream (seed, site, tensor)
    from element ``base`` on (any base, also one that is not a multiple of 4);
    a device seed draws on its own device."""
    if isinstance(seed, torch.Tensor):
        device = seed.device
    skip = int(base) % 4
    first = int(base) // 4
    idx = torch.arange(first, first + -(-(n + skip) // 4), dtype=torch.int64, device=device)
    const = torch.zeros_like(idx)
    words = philox4x32(seed_words(seed), (idx & _MASK32, idx >> 32, const + int(tensor),
                                          const + int(site)))
    return torch.stack(words, dim=1).reshape(-1)[skip:skip + n]


def keep_mask(seed: Seed, site: int, tensor: int, shape: Sequence[int], rate: float,
              device=None, base: int = 0) -> torch.Tensor:
    """The 0/1 float32 keep mask of a logical tensor of ``shape`` whose first
    element is element ``base`` of the stream's tensor."""
    n = 1
    for s in shape:
        n *= int(s)
    bits = random_bits(seed, site, tensor, n, device, base)
    return (bits >= threshold(rate)).to(torch.float32).reshape(tuple(shape))


def _drawn(seed: Seed, site: int, tensor: int, shape, rate: float, device, base: int):
    """:func:`keep_mask` (looked up at the call), with the base only where it
    is not 0: at base 0 the call is one process's, as it always was."""
    if base:
        return keep_mask(seed, site, tensor, shape, rate, device, base=base)
    return keep_mask(seed, site, tensor, shape, rate, device)


def apply_mask(v: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """``v * mask / (1 - rate)`` in float32, the kernels' arithmetic; ``v``
    itself when there is no mask."""
    if mask is None:
        return v
    # a fill on the device, not a copy from the host: capturable into a graph
    return v * mask / torch.full((), 1.0 - rate, dtype=torch.float32, device=v.device)


def resolve_masks(rates: Sequence[float], shapes: Sequence[Sequence[int]], seed: Optional[Seed],
                  site: int, masks, device, bases: Optional[Sequence[int]] = None):
    """One mask (or None at rate 0) for each of a module call's dropped
    tensors: the explicit ``masks`` when given, else drawn from (seed, site),
    each from its element base in ``bases`` (default 0)."""
    check_rates(*rates)
    if masks is not None:
        return [None if r <= 0.0 else m.to(device=device, dtype=torch.float32).reshape(tuple(s))
                for r, s, m in zip(rates, shapes, masks)]
    if seed is None:
        if any(r > 0.0 for r in rates):
            raise ValueError("a dropout rate above 0 needs a seed or explicit masks")
        return [None] * len(rates)
    bases = bases or (0,) * len(rates)
    return [None if r <= 0.0 else _drawn(seed, site, i, s, r, device, b)
            for i, (r, s, b) in enumerate(zip(rates, shapes, bases))]


def cuboid_layer_masks(shape: Sequence[int], num_heads: int, rate_attn: float, rate_proj: float,
                       seed: Optional[Seed], site: int, masks=None, device=None,
                       bases: Optional[Sequence[int]] = None):
    """The two masks of one cuboid attention layer call on ``cuboid_reorder``'s
    layout, x of ``shape`` (B, cuboids, vol, C): tensor 0 the attention
    weights (B, cuboids, heads, vol, vol), tensor 1 the projected output (B,
    cuboids, vol, C) before the reverse reorder, where flax's ``Dropout``
    acts in the JAX layer; None at rate 0.  The general layer's kernels and
    plain versions and the grouped and einsum routes all draw this layout;
    ``bases`` the two masks' element bases."""
    B, nC, vol, C = shape
    return resolve_masks((rate_attn, rate_proj), ((B, nC, num_heads, vol, vol), (B, nC, vol, C)),
                         seed, site, masks, device, bases)


class DropoutStream:
    """The dropout sites of one forward: the seed of the step, a counter
    that numbers the module calls that draw, in call order (the counterpart
    of flax's ``make_rng("dropout")`` folding in the module path), and the
    first global batch row of the rows this forward holds (0 on one
    process; a rank's first row of the global batch on several).  The seed
    is an integer or a device seed (:func:`as_seed`)."""

    def __init__(self, seed: Seed, first_row: int = 0):
        self.seed = as_seed(seed)
        self.site = 0
        self.first_row = int(first_row)

    def next_site(self) -> int:
        site = self.site
        self.site += 1
        return site

    def fork(self, site: int) -> "DropoutStream":
        """A stream of the same seed and rows that numbers on from ``site``:
        a recomputed segment's, which draws the masks its first run drew."""
        stream = DropoutStream(self.seed, self.first_row)
        stream.site = int(site)
        return stream

    def bases(self, *per_row: int) -> Tuple[int, ...]:
        """The element bases of a call's masks, each given by its elements
        per batch row: ``first_row`` times each."""
        return tuple(self.first_row * int(n) for n in per_row)


def kernel_bases(bases: Sequence[int]) -> bool:
    """Whether the dropout kernels take these element bases: multiples of 4
    (``csrc/philox.cuh``); a layer whose bases are not takes its library
    route, whose masks take any base."""
    return all(int(b) % 4 == 0 for b in bases)


def is_active(module: torch.nn.Module, drop: Optional[DropoutStream], *rates: float) -> bool:
    """Whether ``module`` drops in this call: training mode and a rate above
    0.  Raises if it should but was given no stream."""
    if not module.training or not any(r > 0.0 for r in rates):
        return False
    if drop is None:
        raise ValueError(f"{type(module).__name__}: training mode with a dropout rate above 0 "
                         "needs the forward's DropoutStream (pass dropout_seed to the model)")
    return True
