"""Factories: config tree -> models -> the sampling pipeline and the three
trainers (the latent UNet's pipeline, the VAE-GAN's, the alignment net's)."""
from typing import Dict, Optional

import torch

from .config import ConfigDict
from .diffusion.knowledge_alignment import KnowledgeAlignment
from .diffusion.latent_diffusion import LatentDiffusion
from .diffusion.schedule import make_gaussian_schedule
from .models.alignment import NoisyCuboidTransformerEncoder
from .models.init import init_params_
from .models.patterns import CuboidSelfAttentionPatterns
from .models.unet import CuboidTransformerUNet
from .models.vae import AutoencoderKL
from .training.alignment_trainer import AlignmentTrainer
from .training.losses import NLayerDiscriminator
from .training.vae_trainer import VAETrainer
from .utils.device import resolve_device
from .utils.layout import parse_layout_shape
from .utils.precision import floating_dtype


def _check_pattern(pattern) -> None:
    names = [pattern] if isinstance(pattern, str) else list(pattern)
    unknown = [n for n in names if n not in CuboidSelfAttentionPatterns]
    if unknown:
        raise ValueError(f"attention patterns {unknown} are not registered "
                         f"({sorted(CuboidSelfAttentionPatterns)})")


# The knobs the JAX models assert to one value (``prediff_tpu/models/unet.py``
# and ``alignment.py`` refuse any other at their first call); the port
# refuses any other at build time.
UNET_ASSERTED = dict(downsample_type="patch_merge", upsample_type="upsample")
ALIGN_ASSERTED = dict(downsample_type="patch_merge", pool="attention")


def _check_asserted(section, asserted, what: str) -> None:
    for key, want in asserted.items():
        got = section.get(key, want)
        if got != want:
            raise NotImplementedError(f"{what}: {key}={got!r}: only {want!r} is built, in "
                                      "the JAX package too (its model asserts it)")


def _variants(section) -> dict:
    """The model variants both networks build from their section, read
    where the JAX factory reads them (``prediff_tpu/factory.py``); the init
    modes with the JAX factory's defaults.  ``norm_init_mode`` is read and
    used by neither package."""
    s = section
    return dict(
        ffn_activation=s.ffn_activation, gated_ffn=s.gated_ffn, pos_embed_type=s.pos_embed_type,
        use_relative_pos=s.use_relative_pos, self_attn_use_final_proj=s.self_attn_use_final_proj,
        num_global_vectors=s.num_global_vectors, use_global_vector_ffn=s.use_global_vector_ffn,
        use_global_self_attn=s.use_global_self_attn, separate_global_qkv=s.separate_global_qkv,
        global_dim_ratio=s.global_dim_ratio,
        time_embed_use_scale_shift_norm=s.time_embed_use_scale_shift_norm,
        attn_linear_init_mode=s.get("attn_linear_init_mode", "0"),
        ffn_linear_init_mode=s.get("ffn_linear_init_mode", "0"),
        ffn2_linear_init_mode=s.get("ffn2_linear_init_mode", "2"),
        attn_proj_linear_init_mode=s.get("attn_proj_linear_init_mode", "2"),
        global_proj_linear_init_mode=s.get("global_proj_linear_init_mode", "2"))


def _conv_route(section, what: str) -> bool:
    """``use_pallas_conv`` of a model's section: True sends the eligible 3x3x3
    convs to the bf16 conv kernel; False and "auto" keep the f32 convs (the
    JAX package resolves "auto" to its kernel on a TPU only, so off a TPU
    both packages compute the f32 conv for it); any other value raises."""
    value = section.get("use_pallas_conv", False)
    if value is True:
        return True
    if value is False or value == "auto":
        return False
    raise ValueError(f"{what}: use_pallas_conv={value!r} (True, False or 'auto')")


def _kernel_switch(section, key: str, what: str) -> bool:
    """``use_pallas_ffn`` / ``use_pallas_gn`` / ``use_pallas_resblock`` of a
    model's section: True and "auto" (the default) keep the kernels, False
    sends the layers to their f32 library routes, as the JAX layers take
    their flax path for False on any backend; any other value raises."""
    value = section.get(key, "auto")
    if value is True or value == "auto":
        return True
    if value is False:
        return False
    raise ValueError(f"{what}: {key}={value!r} (True, False or 'auto')")


def _attention_kernels(section, what: str) -> str:
    """``use_pallas_attention`` as the JAX layer resolves it
    (``prediff_tpu/ops/dispatch.py`` ``resolve_auto_attn``, then
    ``models/cuboid_attention.py``): "auto" and "layer" the whole-layer
    kernels where they take the layer ("layer"); True the grouped kernel for
    every layer ("grouped"); False and "grouped", which the JAX layer sends
    past both of its kernel branches, the einsum code ("einsum").  Any other
    value raises."""
    value = section.get("use_pallas_attention", "auto")
    if value is True:
        return "grouped"
    if value is False or value == "grouped":
        return "einsum"
    if value in ("auto", "layer"):
        return "layer"
    raise ValueError(f"{what}: use_pallas_attention={value!r} "
                     "(True, False, 'auto', 'layer' or 'grouped')")


def build_unet(cfg: ConfigDict) -> CuboidTransformerUNet:
    m = cfg.model.latent_model
    _check_pattern(m.self_pattern)
    _check_asserted(m, UNET_ASSERTED, "UNet")
    # read for the check: the UNet's time blocks run unfused whatever it says
    _kernel_switch(m, "use_pallas_resblock", "UNet")
    if m.get("use_pallas_dropout", "auto") not in ("auto", True):
        # a TPU dispatch switch: here dropout always runs inside the kernels
        raise NotImplementedError(f"use_pallas_dropout={m.use_pallas_dropout!r} is not ported "
                                  "(ROADMAP.md, not carried over)")
    return CuboidTransformerUNet(
        input_shape=tuple(m.input_shape), target_shape=tuple(m.target_shape),
        base_units=m.base_units, block_units=m.get("block_units"), scale_alpha=m.scale_alpha,
        depth=list(m.depth), downsample=m.downsample, block_attn_patterns=m.self_pattern,
        num_heads=m.num_heads, padding_type=m.padding_type,
        upsample_kernel_size=m.upsample_kernel_size,
        time_embed_channels_mult=m.time_embed_channels_mult,
        unet_res_connect=m.unet_res_connect,
        attn_drop=m.attn_drop, proj_drop=m.proj_drop, ffn_drop=m.ffn_drop,
        time_embed_dropout=m.time_embed_dropout, use_pallas_conv=_conv_route(m, "UNet"),
        attention_kernels=_attention_kernels(m, "UNet"),
        ffn_kernel=_kernel_switch(m, "use_pallas_ffn", "UNet"),
        gn_kernel=_kernel_switch(m, "use_pallas_gn", "UNet"),
        # the JAX build_unet passes down_up_linear_init_mode as the down (and the
        # unread up) mode, and neither hierarchical_pos_embed nor use_inter_ffn
        down_linear_init_mode=m.get("down_up_linear_init_mode", "0"),
        conv_init_mode=m.get("conv_init_mode", "0"), **_variants(m),
    )


def build_vae(cfg: ConfigDict) -> AutoencoderKL:
    v = cfg.model.vae
    return AutoencoderKL(
        in_channels=v.in_channels, out_channels=v.out_channels,
        block_out_channels=tuple(v.block_out_channels), layers_per_block=v.layers_per_block,
        latent_channels=v.latent_channels, norm_num_groups=v.norm_num_groups,
    )


def build_alignment_model(cfg: ConfigDict) -> NoisyCuboidTransformerEncoder:
    a = cfg.model.align.model_args
    _check_pattern(a.block_attn_patterns)
    _check_asserted(a, ALIGN_ASSERTED, "alignment net")
    # conv_init_mode: declared by the JAX net and read by none of its layers
    return NoisyCuboidTransformerEncoder(
        input_shape=tuple(a.input_shape), out_channels=a.out_channels, base_units=a.base_units,
        scale_alpha=a.scale_alpha, depth=list(a.depth), downsample=a.downsample,
        block_attn_patterns=a.block_attn_patterns, num_heads=a.num_heads,
        padding_type=a.padding_type, time_embed_channels_mult=a.time_embed_channels_mult,
        out_len=a.out_len, attn_drop=a.attn_drop, proj_drop=a.proj_drop, ffn_drop=a.ffn_drop,
        time_embed_dropout=a.time_embed_dropout,
        use_pallas_conv=_conv_route(a, "alignment net"),
        attention_kernels=_attention_kernels(a, "alignment net"),
        ffn_kernel=_kernel_switch(a, "use_pallas_ffn", "alignment net"),
        gn_kernel=_kernel_switch(a, "use_pallas_gn", "alignment net"),
        resblock_kernel=_kernel_switch(a, "use_pallas_resblock", "alignment net"),
        use_inter_ffn=a.use_inter_ffn, hierarchical_pos_embed=a.hierarchical_pos_embed,
        readout_seq=a.readout_seq, down_linear_init_mode=a.get("down_linear_init_mode", "0"),
        **_variants(a),
    )


def build_pipeline(cfg: ConfigDict, with_alignment: bool = False, device=None,
                   params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                   seed: int = 0, trainable_unet: bool = False) -> LatentDiffusion:
    """The pipeline on ``device`` (default: the card), with the knowledge
    alignment when ``with_alignment``.

    ``params`` holds state_dicts under "unet", "vae" and "align"; a model
    without one takes the seeded v1 initialisation.  Each model takes its
    state_dict's dtype (every floating tensor of one model in one dtype, else
    ``ValueError``): ``cast_to_bf16(params)`` gives bf16 models, which run as
    flax promotes (``diffusion/latent_diffusion.py``).  For sampling every model
    is frozen and in eval mode: guidance asks each kernel's
    ``autograd.Function`` for dx only, and eval mode ignores the dropout
    rates.  ``trainable_unet`` (what :func:`build_training_pipeline` passes)
    leaves the UNet's parameters requiring grad and puts it in training mode,
    where the configuration's dropout rates are active; the VAE and the
    alignment net stay frozen."""
    axes = parse_layout_shape(cfg.layout.layout)
    if (axes["batch_axis"], axes["t_axis"]) != (0, 1):
        raise ValueError(f"layout {cfg.layout.layout!r}: the port takes batch, then time first")
    dev = resolve_device(device)
    builders = {"unet": lambda: build_unet(cfg), "vae": lambda: build_vae(cfg)}
    if with_alignment:
        builders["align"] = lambda: build_alignment_model(cfg)
    models = _models_on(dev, torch.Generator().manual_seed(seed), params or {}, builders,
                        trainable=("unet",) if trainable_unet else ())
    alignment = None
    if with_alignment:
        al = cfg.model.align
        alignment = KnowledgeAlignment(models["align"], guide_scale=al.guide_scale,
                                       alignment_type=al.alignment_type,
                                       compute_dtype=al.get("compute_dtype", "float32"))
    d = cfg.model.diffusion
    schedule = make_gaussian_schedule(
        beta_schedule=d.beta_schedule, timesteps=d.timesteps, linear_start=d.linear_start,
        linear_end=d.linear_end, cosine_s=d.cosine_s, given_betas=d.given_betas,
        v_posterior=d.v_posterior, parameterization=d.parameterization)
    return LatentDiffusion(
        models["unet"], models["vae"], schedule, latent_shape=d.latent_shape,
        cond_latent_shape=d.latent_cond_shape, parameterization=d.parameterization,
        scale_factor=d.scale_factor, clip_denoised=d.clip_denoised,
        decode_chunk_size=d.get("decode_chunk_size"), alignment=alignment, device=dev,
        learn_logvar=d.learn_logvar, logvar_init=d.logvar_init, log_every_t=d.log_every_t,
        first_stage_dtype=d.get("first_stage_dtype", "auto"))


def build_training_pipeline(cfg: ConfigDict, device=None,
                            params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                            seed: int = 0) -> LatentDiffusion:
    """The pipeline a :class:`~prediff_torch.training.DiffusionTrainer` trains:
    a trainable UNet in training mode, a frozen VAE, no alignment.  Every
    pattern :func:`build_unet` builds trains."""
    return build_pipeline(cfg, with_alignment=False, device=device, params=params, seed=seed,
                          trainable_unet=True)


def _models_on(dev, gen: torch.Generator, params, builders, trainable):
    """Each model of ``builders`` (key -> build fn) from ``params[key]``, in
    its tensors' floating dtype (one a model, else ``ValueError``; f32 for
    those in ``trainable``), or its seeded f32 initialisation, on ``dev``;
    those in ``trainable`` in training mode, the others frozen in eval mode."""
    models = {}
    for key, build in builders.items():
        model = build()
        if key in params:
            dtype = floating_dtype(params[key].values(), f"params[{key!r}]") or torch.float32
            if key in trainable and dtype != torch.float32:
                raise NotImplementedError(f"params[{key!r}] in {dtype}: a model trains on f32 "
                                          "parameters (low-precision training is not ported)")
            model.to(dtype).load_state_dict(params[key])
        elif isinstance(model, NLayerDiscriminator):
            model.reset_parameters(gen)
        else:
            init_params_(model, gen)
        model = model.to(dev)
        models[key] = (model.train() if key in trainable
                       else model.eval().requires_grad_(False))
    return models


def build_discriminator(cfg: ConfigDict) -> NLayerDiscriminator:
    loss = cfg.model.loss
    return NLayerDiscriminator(input_nc=loss.disc_in_channels, n_layers=loss.disc_num_layers,
                               use_actnorm=loss.use_actnorm)


def build_vae_trainer(cfg: ConfigDict, device=None,
                      params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                      seed: int = 0, total_num_steps: int = 100_000, mesh=None) -> VAETrainer:
    """The VAE-GAN trainer of a ``vae_training_default_config()`` tree on
    ``device`` (default: the card), as scripts/train_vae_sevirlr.py builds
    it: the discriminator of ``cfg.model.loss``, Adam(W) with betas (0.5,
    0.9), a constant rate and no clip for both optimizers.  ``params`` holds
    state_dicts under "vae" and "disc"; a model without one takes its seeded
    initialisation.  ``mesh``: the ranks it trains on (``VAETrainer``)."""
    dev = resolve_device(device)
    models = _models_on(dev, torch.Generator().manual_seed(seed), params or {},
                        {"vae": lambda: build_vae(cfg), "disc": lambda: build_discriminator(cfg)},
                        trainable=("vae", "disc"))
    loss = cfg.model.loss
    return VAETrainer(
        models["vae"], models["disc"], disc_start=loss.disc_start, kl_weight=loss.kl_weight,
        disc_weight=loss.disc_weight, disc_factor=loss.disc_factor, disc_loss=loss.disc_loss,
        logvar_init=loss.logvar_init, perceptual_weight=loss.perceptual_weight,
        optim_config=dict(lr=cfg.optim.lr, total_num_steps=total_num_steps, betas=(0.5, 0.9),
                          gradient_clip_val=None, lr_scheduler_mode="constant",
                          warmup_percentage=0.0),
        flat_update=cfg.optim.get("flat_update", False),
        pack_small_thr=cfg.optim.get("pack_small_thr", 0),
        compute_dtype=cfg.optim.get("vae_compute_dtype", None), mesh=mesh)


def build_alignment_trainer(cfg: ConfigDict, device=None,
                            params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                            seed: int = 0, total_num_steps: int = 30_000,
                            latent_inputs: bool = False, mesh=None) -> AlignmentTrainer:
    """The alignment trainer of an ``alignment_default_config()`` tree on
    ``device`` (default: the card), as scripts/train_sevirlr_avg_x.py builds
    it: the alignment net in training mode (its dropout rates active), the
    frozen VAE, the diffusion schedule and scale factor, the recipe's AdamW.
    ``params`` holds state_dicts under "align" and "vae"; a model without one
    takes its seeded initialisation.  ``mesh``: the ranks it trains on
    (``AlignmentTrainer``)."""
    dev = resolve_device(device)
    models = _models_on(dev, torch.Generator().manual_seed(seed), params or {},
                        {"vae": lambda: build_vae(cfg),
                         "align": lambda: build_alignment_model(cfg)}, trainable=("align",))
    d, o = cfg.model.diffusion, cfg.optim
    return AlignmentTrainer(
        models["align"], models["vae"], timesteps=d.timesteps, scale_factor=d.scale_factor,
        optim_config=dict(lr=o.lr, total_num_steps=total_num_steps, wd=o.wd,
                          betas=tuple(o.betas), gradient_clip_val=o.gradient_clip_val,
                          warmup_percentage=o.warmup_percentage),
        latent_inputs=latent_inputs, mesh=mesh, prng_impl=o.get("prng_impl", "auto"),
        flat_update=o.get("flat_update", False), pack_small_thr=o.get("pack_small_thr", 0),
        matmul_precision=o.get("matmul_precision", None),
        conv3d_impl=o.get("conv3d_impl", "auto"))
