"""Each fused layer of the port routes by shape, as the JAX package's layers
do: where a kernel refuses the width (``configs/tiny_smoke.yaml``'s 16 and
32 channels), the layer runs its own library ops in f32.  On the CPU: each
``supports_*`` predicate is True exactly where the checks of its kernel
wrappers pass, over a grid of widths; at C = 16 and 32 the library routes
of ``PositionwiseFFN``, the axial and v4 attention layers, the alignment
net's resblock and a GroupNorm+SiLU match the JAX flax modules (or the
plain version) on the same numpy inputs, forward and input gradient; and
with dropout active the library route takes the site and the masks the
kernel route would."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import randomize_flax

from prediff_tpu.models.cuboid_attention import CuboidSelfAttentionLayer as JaxLayer
from prediff_tpu.models.layers import PositionwiseFFN as JaxFFN
from prediff_tpu.models.layers import TimeEmbedResBlock as JaxBlock
from prediff_torch.models.cuboid_attention import CuboidSelfAttentionLayer
from prediff_torch.models.layers import PositionwiseFFN, TimeEmbedResBlock
from prediff_torch.ops import attention, ffn, groupnorm, resblock
from prediff_torch.ops.cuboid import cuboid_reorder, cuboid_reorder_reverse
from prediff_torch.ops.dropout import DropoutStream
from prediff_torch.utils.convert import flax_params_to_torch

TOL_FWD, TOL_GRAD = 1e-5, 1e-4   # of the output's (the gradient's) max: f32 on both sides


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# ---- the predicates against the wrappers' checks ----
@pytest.mark.parametrize("C", [16, 32, 64, 96, 128, 192, 256, 512, 640])
def test_ffn_predicate_is_the_wrappers_check(C):
    for hidden in (4 * C, 4 * C + 32):
        for M in (1, 100):
            want = C in ffn.KERNEL_WIDTHS and hidden % 64 == 0
            assert ffn.supports_shape(M, C, hidden) == want
            if want:
                ffn.ffn_plan(M, C, hidden), ffn.ffn_bwd_plan(M, C, hidden)
            else:
                for plan in (ffn.ffn_plan, ffn.ffn_bwd_plan):
                    with pytest.raises(ValueError, match="not supported"):
                        plan(M, C, hidden)


@pytest.mark.parametrize("C", [16, 32, 64, 96, 128, 768, 832])
def test_attention_predicates_are_the_wrappers_checks(C):
    heads = 4
    for vol in (1, 5, 13, 64, 128, 256, 300):
        for axis in range(3):
            dims = [2, 3, 4]
            dims[axis] = vol
            x = torch.empty((1, *dims, C), device="meta")
            fwd_ok = C % 64 == 0 and C <= attention.LN_MAX_K and \
                4 * (4 * vol * (C // heads + 1) + 3 * vol * vol) <= 227 * 1024
            assert attention.supports_axial(x.shape, axis, heads) == fwd_ok
            for forward in (True, False):
                try:
                    attention._check(x, axis, heads, forward)
                    passed = True
                except ValueError:
                    passed = False
                assert passed == (fwd_ok if forward else
                                  (fwd_ok or (C % 64 == 0 and C > attention.LN_MAX_K
                                              and attention._axial_refusal(
                                                  x.shape, axis, heads, False) is None)))
            if fwd_ok:
                attention.attention_plan(x.numel() // C, C)
        for n_cuboids in (1, 7):
            x = torch.empty((1, n_cuboids, vol, C), device="meta")
            ok = attention.supports_cuboid(n_cuboids, vol, C, heads)
            try:
                attention._check_cuboid(x, heads)
                attention.cuboid_layer_plan(n_cuboids, vol, C, heads)
                passed = True
            except ValueError:
                passed = False
            assert ok == passed
            if C % 64 or vol > attention.V4_MAX_ROWS:
                assert not ok
            elif C <= attention.LN_MAX_K:
                assert ok     # every cuboid the layer routes to v4 at the model's widths


@pytest.mark.parametrize("C", [16, 32, 48, 64, 96, 128, 256])
def test_resblock_and_groupnorm_predicates_are_the_wrappers_checks(C):
    for groups in (1, 2, 8, 16, 32, C):
        if C % groups:
            continue
        ok = resblock.supports(C, groups)
        try:
            resblock._specs(torch.empty((1, 2, 2, 2, C), device="meta"),
                            torch.empty((1, C), device="meta"), groups)
            passed = True
        except ValueError:
            passed = False
        assert ok == passed == (C % 64 == 0 and 256 % (C // groups) == 0)
    for C2, groups, want in ((16, 16, True), (65, 65, True), (1024, 32, True), (1056, 32, False),
                             (66, 2, False), (96, 32, True), (96, 5, False)):
        assert groupnorm.supports(C2, groups) == want, (C2, groups)


# ---- the library routes at the tiny widths against the flax modules ----
def _grad_pair(jmod, params, x, g, tmod):
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    want_dx = jax.grad(lambda a: jnp.sum(jmod.apply({"params": params}, a) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmod.requires_grad_(False)(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    _close(out.detach().numpy(), want, TOL_FWD)
    _close(dx.numpy(), want_dx, TOL_GRAD)


@pytest.mark.parametrize("C", [16, 32])
def test_ffn_library_route_matches_flax(C):
    x = np.random.RandomState(C).randn(2, 3, 4, 4, C).astype(np.float32)
    g = np.random.RandomState(C + 1).randn(*x.shape).astype(np.float32)
    jmod = JaxFFN(units=C, hidden_size=4 * C, activation="gelu", pre_norm=True,
                  activation_dropout=0.0, dropout=0.0)
    params = randomize_flax(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], C + 2)
    tmod = PositionwiseFFN(C, 4 * C).eval()
    tmod.load_state_dict(flax_params_to_torch(tmod, params))
    assert not ffn.supports_shape(x.size // C, C, 4 * C)
    _grad_pair(jmod, params, x, g, tmod)


@pytest.mark.parametrize("C", [16, 32])
@pytest.mark.parametrize("cs,strategy,route", [((5, 1, 1), ("l", "l", "l"), "axial"),
                                               ((1, 2, 2), ("d", "d", "d"), "v4")])
def test_attention_library_route_matches_flax(C, cs, strategy, route):
    x = np.random.RandomState(C).randn(2, 5, 4, 4, C).astype(np.float32)
    g = np.random.RandomState(C + 1).randn(*x.shape).astype(np.float32)
    jmod = JaxLayer(dim=C, num_heads=4, cuboid_size=cs, strategy=strategy, padding_type="zeros")
    params = randomize_flax(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], C + 3)
    tmod = CuboidSelfAttentionLayer(C, 4, cs, strategy=strategy, padding_type="zeros").eval()
    tmod.load_state_dict(flax_params_to_torch(tmod, params))
    assert tmod.route(x.shape) == "einsum"
    wide = CuboidSelfAttentionLayer(64, 4, cs, strategy=strategy, padding_type="zeros")
    assert wide.route(x.shape[:-1] + (64,)) == route   # the kernel route where the width allows
    _grad_pair(jmod, params, x, g, tmod)


@pytest.mark.parametrize("C", [16, 32])
def test_alignment_resblock_library_route_matches_flax(C):
    rs = np.random.RandomState(C)
    x = rs.randn(1, 2, 4, 4, C).astype(np.float32)
    emb = rs.randn(1, 4 * C).astype(np.float32)
    g = rs.randn(*x.shape).astype(np.float32)
    jmod = JaxBlock(channels=C, emb_channels=4 * C)
    params = randomize_flax(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(emb))
                            ["params"], C + 4)
    tmod = TimeEmbedResBlock(C, C, emb_channels=4 * C, fused=True).eval()
    tmod.load_state_dict(flax_params_to_torch(tmod, params))
    assert not resblock.supports(C, tmod.in_groups)

    class _Bound(torch.nn.Module):   # the block's call with its embedding bound
        def forward(self, a):
            return tmod(a, torch.from_numpy(emb))

    class _JBound:
        def apply(self, variables, a):
            return jmod.apply(variables, a, jnp.asarray(emb))

    _grad_pair(_JBound(), params, x, g, _Bound())


def test_groupnorm_library_route_matches_the_plain_version():
    """A width the GN kernels refuse (33 channels a group: a backward block
    past 1024 threads) takes F.group_norm + SiLU, the function of the GN
    kernels' plain version."""
    norm = torch.nn.GroupNorm(2, 66)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5), norm.bias.uniform_(-0.5, 0.5)
    x = torch.randn(2, 3, 4, 4, 66) * 2.0 + 1.0
    emb = torch.randn(2, 66)
    assert not groupnorm.supports(66, 2)
    got = TimeEmbedResBlock._gn_silu(norm, x, emb)
    want = groupnorm.groupnorm_silu_plain(x.reshape(2, -1, 66), norm.weight, norm.bias, emb, 2)
    _close(got.reshape(2, -1, 66).detach().numpy(), want.detach().numpy(), TOL_FWD)


# ---- dropout: the same sites and masks on both routes ----
SEED = 0x5EED


def test_ffn_library_route_takes_the_kernel_routes_site_and_masks():
    x = torch.randn(2, 3, 4, 4, 16)
    mod = PositionwiseFFN(16, 64, activation_dropout=0.1, dropout=0.2).train()
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0.0, 0.3)
    stream = DropoutStream(SEED)
    stream.site = 3
    got = mod(x, stream)
    assert stream.site == 4                       # one site, as the kernel route takes
    wide = PositionwiseFFN(128, 512, activation_dropout=0.1, dropout=0.2).train()
    stream_wide = DropoutStream(SEED)
    wide(torch.randn(2, 3, 4, 4, 128), stream_wide)
    assert stream_wide.site == 1
    want = ffn.ffn_dropout_plain(x.reshape(-1, 16), mod.layer_norm.weight, mod.layer_norm.bias,
                                 mod.ffn_1.weight, mod.ffn_1.bias, mod.ffn_2.weight,
                                 mod.ffn_2.bias, 1e-5, 0.1, 0.2, SEED, 3)
    _close(got.detach().reshape(-1, 16).numpy(), want.detach().numpy(), TOL_FWD)


@pytest.mark.parametrize("cs,strategy", [((5, 1, 1), ("l", "l", "l")), ((1, 2, 2), ("d", "d", "d"))])
def test_attention_library_route_takes_the_kernel_routes_site_and_masks(cs, strategy):
    C, heads = 32, 4
    x = torch.randn(2, 5, 4, 4, C)
    mod = CuboidSelfAttentionLayer(C, heads, cs, strategy=strategy, padding_type="zeros",
                                   attn_drop=0.1, proj_drop=0.2).train()
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0.0, 0.3)
    assert mod.route(x.shape) == "einsum"
    stream = DropoutStream(SEED)
    stream.site = 5
    got = mod(x, stream)
    assert stream.site == 6
    args = (mod.norm.weight, mod.norm.bias, mod.qkv.weight, mod.rel_bias(5 if cs[0] == 5 else 4),
            mod.proj.weight, mod.proj.bias, heads, mod.scale)
    drop = dict(rate_attn=0.1, rate_proj=0.2, seed=SEED, site=5)
    if cs[0] == 5:   # the axial kernel route's plain version: the output mask on (B, T, H, W, C)
        want = attention.axial_attention_plain(x, 0, *args, **drop)
    else:            # the v4 route's: both masks on the reordered layout
        xr = cuboid_reorder(x, cs, strategy)
        want = cuboid_reorder_reverse(attention.cuboid_attention_plain(xr, *args, **drop), cs,
                                      strategy, (5, 4, 4))
    _close(got.detach().numpy(), want.detach().numpy(), TOL_FWD)
