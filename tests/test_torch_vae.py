"""VAE: the port's encode_moments and decode against the flax AutoencoderKL
with every leaf randomized and carried over by the weight bridge (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import randomize_flax

from prediff_tpu.models.vae import AutoencoderKL as JaxVAE
from prediff_torch.models.vae import AutoencoderKL
from prediff_torch.utils.convert import flax_params_to_torch

# f32 on both sides; convolution sums run in another order
ATOL = RTOL = 1e-4

KW = dict(in_channels=1, out_channels=1, block_out_channels=(16, 32, 32), layers_per_block=1,
          latent_channels=8, norm_num_groups=16)



@pytest.fixture(scope="module")
def vaes():
    jvae = JaxVAE(down_block_types=("DownEncoderBlock2D",) * 3,
                  up_block_types=("UpDecoderBlock2D",) * 3, decoder_subpixel=False, **KW)
    x = np.random.RandomState(2).randn(2, 32, 32, 1).astype(np.float32)
    params = jvae.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = randomize_flax(params, seed=3)
    tvae = AutoencoderKL(**KW).eval()
    tvae.load_state_dict(flax_params_to_torch(tvae, params))
    return jvae, params, tvae, x


def test_encode_moments_matches_flax(vaes):
    jvae, params, tvae, x = vaes
    want = np.asarray(jvae.apply({"params": params}, jnp.asarray(x),
                                 method=JaxVAE.encode_moments))
    with torch.no_grad():
        got = tvae.encode_moments(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8, 8, 16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_decode_matches_flax(vaes):
    jvae, params, tvae, _ = vaes
    z = np.random.RandomState(4).randn(2, 8, 8, 8).astype(np.float32)
    want = np.asarray(jvae.apply({"params": params}, jnp.asarray(z), method=JaxVAE.decode))
    with torch.no_grad():
        got = tvae.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
