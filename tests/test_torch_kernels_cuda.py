"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the shapes the v1 UNet gives them.  Every test needs a CUDA device and
skips without one.  This file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from prediff_torch.ops.attention import axial_attention_plain, fused_axial_attention
from prediff_torch.ops.ffn import ffn_plain, fused_ffn
from prediff_torch.ops.groupnorm import fused_groupnorm_silu, groupnorm_silu_plain

pytestmark = pytest.mark.cuda

# GN: f32 both ways, another sum order.  FFN / attention: bf16 operands
# rounded at the same points on both sides; a 1-ulp f32 difference before a
# rounding can flip one operand, which moves a few outputs by up to ~1e-2
# while the mean error stays ~1e-5.
TOL_GN = 1e-4
TOL_BF16 = 2e-2
MEAN_TOL_BF16 = 1e-4


@pytest.fixture
def dev():
    """The card; decided per test, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.manual_seed(0)
    return torch.device("cuda")


def _close_bf16(got, want):
    err = (got - want).abs()
    assert err.max().item() <= TOL_BF16, err.max().item()
    assert err.mean().item() <= MEAN_TOL_BF16, err.mean().item()


@pytest.mark.parametrize("N,C,groups", [(3328, 256, 32), (832, 512, 32), (3328, 65, 65)])
@pytest.mark.parametrize("with_emb", [False, True])
def test_groupnorm_kernel_matches_plain(dev, N, C, groups, with_emb):
    x = torch.randn(1, N, C, device=dev) * 2.0 + 3.0
    w = 1.0 + 0.1 * torch.randn(C, device=dev)
    b = 0.1 * torch.randn(C, device=dev)
    emb = torch.randn(1, C, device=dev) if with_emb else None
    before = fused_groupnorm_silu.launches
    got = fused_groupnorm_silu(x, w, b, emb, groups=groups)
    torch.testing.assert_close(got, groupnorm_silu_plain(x, w, b, emb, groups=groups),
                               rtol=TOL_GN, atol=TOL_GN)
    assert fused_groupnorm_silu.launches == before + 1


@pytest.mark.parametrize("M,C", [(3328, 256), (832, 512), (100, 128)])
def test_ffn_kernel_matches_plain(dev, M, C):
    hid = 4 * C
    args = (torch.randn(M, C, device=dev), 1.0 + 0.1 * torch.randn(C, device=dev),
            0.1 * torch.randn(C, device=dev), torch.randn(hid, C, device=dev) / C ** 0.5,
            0.1 * torch.randn(hid, device=dev), torch.randn(C, hid, device=dev) / hid ** 0.5,
            0.1 * torch.randn(C, device=dev))
    _close_bf16(fused_ffn(*args), ffn_plain(*args, mxu_dtype=torch.bfloat16))


@pytest.mark.parametrize("shape", [(1, 13, 16, 16, 256), (1, 13, 8, 8, 512), (2, 5, 3, 7, 64)])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_attention_kernel_matches_plain(dev, shape, axis):
    heads = 4
    B, T, H, W, C = shape
    vol = (T, H, W)[axis]
    args = (torch.randn(*shape, device=dev), 1.0 + 0.1 * torch.randn(C, device=dev),
            0.1 * torch.randn(C, device=dev), torch.randn(3 * C, C, device=dev) / C ** 0.5,
            0.5 * torch.randn(heads, vol, vol, device=dev), torch.randn(C, C, device=dev) / C ** 0.5,
            0.1 * torch.randn(C, device=dev))
    scale = (C // heads) ** -0.5
    got = fused_axial_attention(args[0], axis, *args[1:], heads, scale)
    want = axial_attention_plain(args[0], axis, *args[1:], heads, scale, mxu_dtype=torch.bfloat16)
    _close_bf16(got, want)


def test_kernels_raise_on_what_they_do_not_take(dev):
    with pytest.raises(ValueError):
        fused_ffn(*(torch.randn(s, device=dev) for s in
                    [(8, 96), (96,), (96,), (384, 96), (384,), (96, 384), (96,)]))
    x = torch.randn(1, 8, 64, device=dev).transpose(1, 2)   # not contiguous
    with pytest.raises(ValueError):
        fused_groupnorm_silu(x, torch.ones(8, device=dev), torch.zeros(8, device=dev), groups=8)
