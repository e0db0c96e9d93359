"""Guidance in bf16 (``KnowledgeAlignment(compute_dtype=...)``) held to the
JAX package's ``get_mean_shift`` with the same randomized weights (CPU), on
the alignment net of tests/test_torch_alignment.py (both resblocks at the
fused widths, three axial layers a stage, so every kernel's wrapper runs its
plain version on bf16 tensors).

The JAX rule: where the guidance dtype differs from z_t's the net runs on its
parameters and z_t cast to the guidance dtype and the shift comes back in
z_t's dtype; where they agree the net keeps its own (f32) parameters, and the
shift is grad(sq) (in z_t's dtype) over the f32 sqrt, so f32.  Held for the
three mixes (guidance bf16 on an f32 carry, f32 guidance on a bf16 carry,
both bf16) at rel-L2 5e-2 and cosine 0.99 (the f32 bars of the card's shift
check), with JAX's dtype; a zero-error target stays finite; the bf16 copy is
made once per parameter version and follows an in-place update."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_alignment import KW
from test_torch_unet import randomize_flax

from prediff_tpu.diffusion.knowledge_alignment import KnowledgeAlignment as JaxAlignment
from prediff_tpu.models.alignment import NoisyCuboidTransformerEncoder as JaxEncoder
from prediff_torch.diffusion.knowledge_alignment import KnowledgeAlignment
from prediff_torch.models.alignment import NoisyCuboidTransformerEncoder
from prediff_torch.utils.convert import flax_params_to_torch

REL_L2, MIN_COSINE = 5e-2, 0.99
AVG = np.array([[0.4], [0.6]], np.float32)


@pytest.fixture(scope="module")
def nets():
    import jax

    jnet = JaxEncoder(attn_drop=0.0, proj_drop=0.0, ffn_drop=0.0, ffn_activation="gelu",
                      readout_seq=True, **KW)
    rs = np.random.RandomState(11)
    zt = (rs.randn(2, 2, 8, 8, 64) * 0.5).astype(np.float32)
    t = np.array([3, 7], np.int32)
    params = randomize_flax(
        jnet.init(jax.random.PRNGKey(0), jnp.asarray(zt), jnp.asarray(t))["params"], seed=12)
    tnet = NoisyCuboidTransformerEncoder(**KW).eval().requires_grad_(False)
    tnet.load_state_dict(flax_params_to_torch(tnet, params))
    return jnet, params, tnet, zt, t


MIXES = {"guidance_bf16": ("bfloat16", "float32", "float32"),
         "carry_bf16": ("float32", "bfloat16", "bfloat16"),
         "both_bf16": ("bfloat16", "bfloat16", "float32")}


@pytest.mark.parametrize("mix", list(MIXES))
def test_mean_shift_matches_jax(nets, mix):
    jnet, params, tnet, zt, t = nets
    guidance, carry, out_dtype = MIXES[mix]
    jz = jnp.asarray(zt, jnp.dtype(carry))
    want = JaxAlignment(params=params, apply_fn=jnet.apply, compute_dtype=guidance,
                        guide_scale=2.0).get_mean_shift(jz, jnp.asarray(t), jnp.asarray(AVG))
    ka = KnowledgeAlignment(tnet, guide_scale=2.0, compute_dtype=guidance)
    tz = torch.from_numpy(np.array(jz.astype(jnp.float32))).to(getattr(torch, carry))
    with torch.no_grad():
        got = ka.get_mean_shift(tz, torch.from_numpy(t).long(), torch.from_numpy(AVG))
    assert str(want.dtype) == out_dtype and got.dtype == getattr(torch, out_dtype)
    g, w = got.float().numpy().ravel().astype(np.float64), np.asarray(want, np.float64).ravel()
    assert np.isfinite(g).all()
    assert np.linalg.norm(g - w) / np.linalg.norm(w) <= REL_L2
    assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= MIN_COSINE
    # the net guidance ran: its bf16 copy for bf16 guidance on an f32 carry, else the
    # net itself (already in the guidance dtype, or kept where the dtypes agree)
    low = (guidance, carry) == ("bfloat16", "float32")
    assert ka.modules(tz.dtype)[-1] is (ka._low.copy if low else tnet)
    assert (ka._low.copy is None) != low


def test_zero_error_target_stays_finite(nets):
    _, _, tnet, zt, t = nets
    ka = KnowledgeAlignment(tnet, compute_dtype="bfloat16")
    z, tt = torch.from_numpy(zt), torch.from_numpy(t).long()
    with torch.no_grad():
        avg = ka.predict(z.bfloat16(), tt, net=ka._low.get()).float().mean(dim=1)
        shift = ka.get_mean_shift(z, tt, avg)
    assert shift.dtype == torch.float32 and torch.isfinite(shift).all()


def test_bf16_copy_follows_the_parameters(nets):
    _, _, tnet, zt, t = nets
    ka = KnowledgeAlignment(tnet, compute_dtype="bfloat16")
    z, tt, avg = torch.from_numpy(zt), torch.from_numpy(t).long(), torch.from_numpy(AVG)
    before = ka.get_mean_shift(z, tt, avg)
    low = ka._low.copy
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in low.parameters())
    assert ka.tracked() == [tnet, low]
    w = tnet.first_proj.in_layers[2].weight
    saved = w.detach().clone()
    try:
        with torch.no_grad():
            w.mul_(1.5)
        after = ka.get_mean_shift(z, tt, avg)
        assert ka._low.copy is low   # brought up to date in place, not made anew
        torch.testing.assert_close(low.first_proj.in_layers[2].weight, w.to(torch.bfloat16),
                                   rtol=0, atol=0)
        assert not torch.equal(before, after)
    finally:
        with torch.no_grad():
            w.copy_(saved)
