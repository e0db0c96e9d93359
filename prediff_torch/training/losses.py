"""VAE-GAN training losses: the PatchGAN discriminator and the generator and
discriminator objectives with the adaptive GAN weight.

Counterpart of ``prediff_tpu/training/losses.py`` (reference
LPIPSWithDiscriminator, taming/losses/contperceptual.py:33, and
NLayerDiscriminator, taming/losses/model.py:100).  Inputs and logits are
NHWC, as the JAX package's; inside, the discriminator runs NCHW on PyTorch's
convolutions.  Its BatchNorm follows flax's, not ``nn.BatchNorm2d``'s
forward: a training-mode call normalises by the batch's statistics, flax's
``mean = E[x]``, ``var = max(0, E[x^2] - E[x]^2)``, and only
``update_stats=True`` moves the running averages, with flax's momentum (0.9,
torch's 0.1) and that biased variance.  On several ranks (``mesh``) the two
means are over the global batch, all-reduced differentiably
(``parallel.all_reduce_sum_grad``; ``nn.SyncBatchNorm`` takes no CPU
tensors), as the JAX step normalises its sharded batch; ActNorm's data
initialisation takes the global batch too, and the adaptive weight the norms
of the all-reduced gradients.  The ``disc_start`` gate is a host test of the
step count.
"""
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import DataMesh, all_reduce_mean, all_reduce_sum, all_reduce_sum_grad


class ActNorm2D(nn.Module):
    """Affine per-channel norm with a data-dependent initialisation
    (reference model.py:15-97): :meth:`initialize` sets loc = -mean and
    scale = 1 / (std + 1e-6) per channel over (B, H, W), with the unbiased std
    the reference takes, and scale 1 where the std is 0.  Built as the
    identity, which is what a constant first batch gives."""

    def __init__(self, num_features: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, num_features, 1, 1))
        self.scale = nn.Parameter(torch.ones(1, num_features, 1, 1))

    @torch.no_grad()
    def initialize(self, x: torch.Tensor, mesh: Optional[DataMesh] = None) -> None:
        """``x``: an NCHW batch as it reaches this layer; with a mesh this
        rank's rows of the global batch, whose statistics it takes."""
        if mesh is None:
            std = x.std(dim=(0, 2, 3), correction=1)
            mean = x.mean(dim=(0, 2, 3))
        else:
            count = x.numel() // x.shape[1] * mesh.size
            mean = all_reduce_sum(x.sum(dim=(0, 2, 3)), mesh) / count
            sq = all_reduce_sum((x - mean[None, :, None, None]).square().sum(dim=(0, 2, 3)), mesh)
            std = torch.sqrt(sq / (count - 1))
        self.loc.copy_(-mean.reshape(self.loc.shape))
        self.scale.copy_(torch.where(std > 0, 1.0 / (std + 1e-6), torch.ones_like(std))
                         .reshape(self.scale.shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * (x + self.loc)


class NLayerDiscriminator(nn.Module):
    """Pix2Pix PatchGAN discriminator: 4x4 convolutions, stride 2 then 1,
    padding 1, BatchNorm (or ActNorm) and LeakyReLU 0.2.  ``main`` holds the
    reference's ``nn.Sequential`` indices (a LeakyReLU takes a slot), so its
    state_dict names are the reference's and the bridge maps them to the
    flax ``main_{i}`` names."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False):
        super().__init__()
        self.use_actnorm = use_actnorm

        def norm(ch):
            return ActNorm2D(ch) if use_actnorm else nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)

        layers = [nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers):
            prev, mult = mult, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, stride=2, padding=1,
                                 bias=use_actnorm), norm(ndf * mult), nn.LeakyReLU(0.2)]
        prev, mult = mult, min(2 ** n_layers, 8)
        layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, stride=1, padding=1, bias=use_actnorm),
                   norm(ndf * mult), nn.LeakyReLU(0.2),
                   nn.Conv2d(ndf * mult, 1, 4, stride=1, padding=1)]
        self.main = nn.Sequential(*layers)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "NLayerDiscriminator":
        """The JAX discriminator's initialisation: conv kernels N(0, 0.02)
        from ``generator`` (a CPU generator), biases 0, norms the identity,
        running statistics mean 0 and variance 1."""
        for m in self.main:
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * 0.02)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, ActNorm2D):
                m.loc.zero_()
                m.scale.fill_(1.0)
        return self

    @torch.no_grad()
    def data_init(self, x: torch.Tensor, mesh: Optional[DataMesh] = None) -> None:
        """Initialise every ActNorm from its input when ``x`` (NHWC; with a
        mesh this rank's rows of the global batch) runs through, as flax's
        ``init`` on a first batch does."""
        h = x.permute(0, 3, 1, 2)
        for m in self.main:
            if isinstance(m, ActNorm2D):
                m.initialize(h, mesh)
            h = m(h)

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The BatchNorms' running statistics, state_dict name -> live buffer
        (empty with ActNorm)."""
        return {f"main.{i}.{k}": getattr(m, k) for i, m in enumerate(self.main)
                if isinstance(m, nn.BatchNorm2d) for k in ("running_mean", "running_var")}

    @staticmethod
    def _batch_norm(bn: nn.BatchNorm2d, h: torch.Tensor, train: bool, update_stats: bool,
                    mesh: Optional[DataMesh] = None) -> torch.Tensor:
        if not train:
            return F.batch_norm(h, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                training=False, eps=bn.eps)
        # flax's statistics: E[x] and E[x^2] (over the global batch on a mesh)
        moments = torch.stack([h.mean(dim=(0, 2, 3)), h.square().mean(dim=(0, 2, 3))])
        if mesh is not None:
            moments = all_reduce_sum_grad(moments, mesh) / mesh.size
        mean, mean2 = moments[0], moments[1]
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        if update_stats:
            with torch.no_grad():
                bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
                bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
                bn.num_batches_tracked.add_(1)
        scale = bn.weight * torch.rsqrt(var + bn.eps)
        return ((h - mean[None, :, None, None]) * scale[None, :, None, None]
                + bn.bias[None, :, None, None])

    def forward(self, x: torch.Tensor, train: bool = False, update_stats: bool = False,
                mesh: Optional[DataMesh] = None) -> torch.Tensor:
        """NHWC images -> NHWC patch logits.  ``train`` normalises by the
        batch's statistics (with ``mesh``, x is this rank's rows and the
        statistics the global batch's); ``update_stats`` (with ``train``) also
        moves the running averages, once, after this batch."""
        h = x.permute(0, 3, 1, 2)
        for m in self.main:
            h = (self._batch_norm(m, h, train, update_stats, mesh)
                 if isinstance(m, nn.BatchNorm2d) else m(h))
        if min(h.shape) <= 0:
            raise ValueError(f"input too small for this PatchGAN: logits shape {tuple(h.shape)}")
        return h.permute(0, 2, 3, 1)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """The ``disc_start`` gate: ``value`` before step ``threshold``."""
    return value if global_step < threshold else weight


def generator_loss(inputs: torch.Tensor, reconstructions: torch.Tensor,
                   posterior_kl: torch.Tensor, logvar: torch.Tensor, logits_fake: torch.Tensor,
                   d_weight: torch.Tensor, global_step: int, disc_start: int,
                   kl_weight: float = 1.0, disc_factor: float = 1.0,
                   perceptual: Optional[torch.Tensor] = None, perceptual_weight: float = 1.0,
                   split: str = "train") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L1 (+ perceptual) reconstruction under the learned ``logvar``, the KL
    and the adaptive adversarial term: ``(loss, log)``."""
    batch = inputs.shape[0]
    rec_loss = (inputs - reconstructions).abs()
    if perceptual is not None and perceptual_weight > 0:
        rec_loss = rec_loss + perceptual_weight * perceptual
    nll_loss = torch.sum(rec_loss / torch.exp(logvar) + logvar) / batch
    kl_loss = torch.sum(posterior_kl) / batch
    g_loss = -logits_fake.mean()
    factor = adopt_weight(disc_factor, global_step, threshold=disc_start)
    loss = nll_loss + kl_weight * kl_loss + d_weight * factor * g_loss
    # logvar's value at this step: the parameter itself moves in place with the update
    log = {f"{split}/total_loss": loss, f"{split}/logvar": logvar.detach().clone(),
           f"{split}/kl_loss": kl_loss,
           f"{split}/nll_loss": nll_loss, f"{split}/rec_loss": rec_loss.mean(),
           f"{split}/d_weight": d_weight,
           f"{split}/disc_factor": torch.tensor(factor, device=loss.device),
           f"{split}/g_loss": g_loss}
    return loss, log


def discriminator_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor, global_step: int,
                       disc_start: int, disc_factor: float = 1.0, disc_loss: str = "hinge",
                       split: str = "train") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    if disc_loss not in ("hinge", "vanilla"):
        raise NotImplementedError(f"disc_loss '{disc_loss}'")
    loss_fn = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss
    factor = adopt_weight(disc_factor, global_step, threshold=disc_start)
    d_loss = factor * loss_fn(logits_real, logits_fake)
    log = {f"{split}/disc_loss": d_loss, f"{split}/logits_real": logits_real.mean(),
           f"{split}/logits_fake": logits_fake.mean()}
    return d_loss, log


def calculate_adaptive_weight(nll_of_kernel: Callable[[torch.Tensor], torch.Tensor],
                              g_of_kernel: Callable[[torch.Tensor], torch.Tensor],
                              last_kernel: torch.Tensor,
                              discriminator_weight: float = 1.0,
                              mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """||d nll / d W|| / (||d g / d W|| + 1e-4) for the decoder's last
    kernel ``W``, clipped to [0, 1e4], detached, times
    ``discriminator_weight`` (reference contperceptual.py:58-68).  Each
    gradient is ``torch.autograd.grad`` with respect to a detached copy of
    ``W`` alone, so nothing else the two functions read gathers a ``.grad``;
    with a mesh both gradients are all-reduced (their means over the ranks:
    the global batch's) before the norms."""
    grads = []
    with torch.enable_grad():
        for fn in (nll_of_kernel, g_of_kernel):
            kernel = last_kernel.detach().requires_grad_(True)
            grads.append(torch.autograd.grad(fn(kernel), kernel)[0])
    grads = all_reduce_mean(grads, mesh)
    d_weight = torch.linalg.vector_norm(grads[0]) / (torch.linalg.vector_norm(grads[1]) + 1e-4)
    return d_weight.clamp(0.0, 1e4).detach() * discriminator_weight
