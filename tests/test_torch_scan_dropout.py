"""Device seeds (``ops/dropout.py``): a one-element int64 tensor holding a
dropout seed, which the kernels read from its address so that a captured
training step draws new masks every replay.  On the CPU: the masks, the
draws and a forward's dropout stream of a device seed against those of the
integer it holds, and the plain versions of rows 15a-15d (the FFN and axial
attention dropout forms, forward and all gradients) and of the general
cuboid layer's dropout forms on a device seed against the integer, bit for
bit, at several element bases; the kernels' argument plumbing."""
import numpy as np
import pytest
import torch

from prediff_torch.ops import _build
from prediff_torch.ops.attention import (axial_attention_bwd_full_plain, axial_attention_plain,
                                         cuboid_attention_dropout_bwd_full_plain,
                                         cuboid_attention_dropout_plain)
from prediff_torch.ops.dropout import (DropoutStream, as_seed, device_seed, keep_mask,
                                       random_bits, seed_words, signed64)
from prediff_torch.ops.ffn import ffn_dropout_bwd_full_plain, ffn_dropout_plain

SEEDS = (0, 7, 0x5EED_0F_D20905, 2 ** 63 + 11, 2 ** 64 - 1)
BASES = ((0, 0), (4 * 5678, 4 * 91), (2 ** 32 + 4 * 1234, 4 * 5678))


@pytest.mark.parametrize("seed", SEEDS)
def test_device_seed_masks_are_the_integer_seeds(seed):
    t = device_seed(seed)
    assert t.dtype == torch.int64 and t.numel() == 1 and int(t) == signed64(seed)
    lo, hi = seed_words(t)
    assert (int(lo), int(hi)) == seed_words(seed)
    for base in (0, 3, 4 * 777, 2 ** 32 + 2):
        assert torch.equal(random_bits(t, 5, 1, 37, base=base), random_bits(seed, 5, 1, 37,
                                                                            base=base))
        assert torch.equal(keep_mask(t, 2, 0, (3, 11), 0.1, base=base),
                           keep_mask(seed, 2, 0, (3, 11), 0.1, base=base))
    stream = DropoutStream(t, first_row=2)
    assert stream.seed is t and stream.fork(4).seed is t and stream.bases(5) == (10,)


def test_as_seed_and_the_kernel_arguments():
    assert as_seed(-1) == 2 ** 64 - 1
    with pytest.raises(ValueError):
        as_seed(torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        as_seed(torch.zeros(1, dtype=torch.int32))
    t = device_seed(2 ** 63 + 11)
    args = _build.drop_args(t, 3, 0.1, 0.0, (4, 8))
    assert args[:4] == [t.data_ptr(), 0, 0, 3] and args[-2:] == [4, 8]
    host = _build.drop_args(2 ** 63 + 11, 3, 0.1, 0.0, (4, 8))
    assert host[0] is None and host[1:3] == list(seed_words(2 ** 63 + 11))
    assert args[4:] == host[4:] and len(args) == len(_build.DROP_ARGTYPES)
    with pytest.raises(ValueError, match="device seed"):
        _build.drop_args(t, 3, 0.1, 0.0, (4, 8), torch.device("cuda", 0))


def _rand(*shape, scale=1.0, shift=0.0, rs):
    return torch.from_numpy((rs.randn(*shape) * scale + shift).astype(np.float32))


@pytest.mark.parametrize("bases", BASES)
def test_plain_dropout_forms_on_a_device_seed(bases):
    """Rows 15a-15d's plain versions, and the general layer's (15e), with a
    device seed equal to those with the integer it holds."""
    rs = np.random.RandomState(1)
    seed = 0x5EED_0F_D20905
    dseed = device_seed(seed)
    drop = (0.1, 0.1)
    M, C = 24, 16
    x, g = _rand(M, C, rs=rs), _rand(M, C, rs=rs)
    ln_w, ln_b = _rand(C, scale=0.1, shift=1.0, rs=rs), _rand(C, scale=0.1, rs=rs)
    w1, b1 = _rand(4 * C, C, scale=C ** -0.5, rs=rs), _rand(4 * C, scale=0.1, rs=rs)
    w2, b2 = _rand(C, 4 * C, scale=0.1, rs=rs), _rand(C, scale=0.1, rs=rs)
    a = ffn_dropout_plain(x, ln_w, ln_b, w1, b1, w2, b2, 1e-5, *drop, dseed, 3, bases=bases)
    b = ffn_dropout_plain(x, ln_w, ln_b, w1, b1, w2, b2, 1e-5, *drop, seed, 3, bases=bases)
    assert torch.equal(a, b) and not torch.equal(a, ffn_dropout_plain(
        x, ln_w, ln_b, w1, b1, w2, b2, 1e-5, *drop, device_seed(seed + 1), 3, bases=bases))
    ga = ffn_dropout_bwd_full_plain(x, g, ln_w, ln_b, w1, b1, w2, 1e-5, *drop, dseed, 3,
                                    bases=bases)
    gb = ffn_dropout_bwd_full_plain(x, g, ln_w, ln_b, w1, b1, w2, 1e-5, *drop, seed, 3,
                                    bases=bases)
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))

    B, T, H, W, heads = 2, 3, 4, 4, 2
    xa, ga5 = _rand(B, T, H, W, C, rs=rs), _rand(B, T, H, W, C, rs=rs)
    w_qkv, w_proj = _rand(3 * C, C, scale=C ** -0.5, rs=rs), _rand(C, C, scale=C ** -0.5, rs=rs)
    b_proj = _rand(C, scale=0.1, rs=rs)
    for axis in range(3):
        vol = (T, H, W)[axis]
        bias = _rand(heads, vol, vol, scale=0.5, rs=rs)
        common = (axis, ln_w, ln_b, w_qkv, bias, w_proj)
        a = axial_attention_plain(xa, *common, b_proj, heads, 0.5, 1e-5, None, *drop, dseed, 4,
                                  bases=bases)
        b = axial_attention_plain(xa, *common, b_proj, heads, 0.5, 1e-5, None, *drop, seed, 4,
                                  bases=bases)
        assert torch.equal(a, b)
        ga = axial_attention_bwd_full_plain(xa, ga5, *common, heads, 0.5, 1e-5, None, *drop,
                                            dseed, 4, bases=bases)
        gb = axial_attention_bwd_full_plain(xa, ga5, *common, heads, 0.5, 1e-5, None, *drop,
                                            seed, 4, bases=bases)
        assert all(torch.equal(u, v) for u, v in zip(ga, gb))

    nC, vol = 3, 8
    xc, gc = _rand(1, nC, vol, C, rs=rs), _rand(1, nC, vol, C, rs=rs)
    bias = _rand(heads, vol, vol, scale=0.5, rs=rs)
    common = (ln_w, ln_b, w_qkv, bias, w_proj)
    a = cuboid_attention_dropout_plain(xc, *common, b_proj, heads, 0.5, 1e-5, None, *drop,
                                       dseed, 5, bases=bases)
    b = cuboid_attention_dropout_plain(xc, *common, b_proj, heads, 0.5, 1e-5, None, *drop,
                                       seed, 5, bases=bases)
    assert torch.equal(a, b)
    ga = cuboid_attention_dropout_bwd_full_plain(xc, gc, *common, heads, 0.5, 1e-5, None,
                                                 *drop, dseed, 5, bases=bases)
    gb = cuboid_attention_dropout_bwd_full_plain(xc, gc, *common, heads, 0.5, 1e-5, None,
                                                 *drop, seed, 5, bases=bases)
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))
