"""Config system: nested defaults-in-code merged with YAML overrides.

The port's own copy of the JAX package's config tree: the same keys and
values (the tests hold the two trees equal), so one YAML file configures
both packages.  ``use_pallas_conv`` (UNet and alignment net) is read by the
factories: True sends each 3x3x3 conv that the JAX package's routing rule
admits to the bf16 conv kernel (``ops/conv3d.py``), False and "auto" keep
the f32 convs.  ``use_pallas_attention``, ``use_pallas_ffn``,
``use_pallas_gn`` and ``use_pallas_resblock`` are read by the factories too
(``factory._attention_kernels`` / ``_kernel_switch``): True and "auto" keep
the kernels (``use_pallas_attention: true`` the grouped kernel for every
layer, as the JAX layer's True), False sends the layers to their f32 library
routes, as the JAX layers compute their flax path for False; any other value
raises.  ``diffusion.first_stage_dtype`` is read by the pipeline
factories: the encoder computes in the dtype it names (``"auto"``: f32, the
JAX package's resolution off a TPU).  The other keys that name TPU-only
switches (``decoder_subpixel``, ...) are kept for tree equality and read by
nothing in the port; ``use_pallas_dropout`` is read only to refuse False
(dropout always runs in the kernels here)."""
import copy
from typing import Dict, Optional

import yaml


class ConfigDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    @classmethod
    def wrap(cls, d):
        if isinstance(d, dict):
            return cls({k: cls.wrap(v) for k, v in d.items()})
        if isinstance(d, list):
            return [cls.wrap(v) for v in d]
        return d

    def to_dict(self) -> Dict:
        def unwrap(v):
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)


def deep_merge(base: Dict, override: Optional[Dict]) -> Dict:
    """Recursive merge; override wins, dicts merge, everything else replaces."""
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_yaml(path: str) -> Dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def save_yaml(cfg: Dict, path: str):
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict() if isinstance(cfg, ConfigDict) else cfg, f,
                       sort_keys=False)


# --------------------------------------------------------------------- #
# Default config trees (PreDiff SEVIR-LR v1 values)
# --------------------------------------------------------------------- #

def layout_default() -> Dict:
    return dict(in_len=7, out_len=6, img_height=128, img_width=128,
                data_channels=1, layout="NTHWC")


def dataset_default() -> Dict:
    return dict(
        dataset_name="sevirlr", img_height=128, img_width=128, in_len=7,
        out_len=6, seq_len=13, plot_stride=1, interval_real_time=10,
        sample_mode="sequent", stride=6, layout="NTHWC", start_date=None,
        train_test_split_date=[2019, 6, 1], end_date=None, val_ratio=0.1,
        metrics_mode="0", metrics_list=["csi", "pod", "sucr", "bias"],
        threshold_list=[16, 74, 133, 160, 181, 219], aug_mode="2",
    )


def optim_default() -> Dict:
    return dict(
        total_batch_size=64, micro_batch_size=2, seed=0,
        float32_matmul_precision="high",
        prng_impl="auto",
        flat_update=False,
        pack_small_thr=0,
        matmul_precision=None,
        state_dtype=None,   # Adam moments stored in "bfloat16" / "float16" / "float32"
        ema_dtype=None,     # the EMA shadow stored likewise (DiffusionTrainer)
        vae_compute_dtype=None,
        conv3d_impl="auto",
        method="adamw",
        lr=1.0e-3, wd=1.0e-5, betas=[0.9, 0.999], gradient_clip_val=1.0,
        max_epochs=2000, loss_type="l2", warmup_percentage=0.1,
        lr_scheduler_mode="cosine", min_lr_ratio=1.0e-3,
        warmup_min_lr_ratio=0.1, monitor="valid_loss_epoch", early_stop=False,
        early_stop_mode="min", early_stop_patience=100, save_top_k=3,
    )


def diffusion_default() -> Dict:
    return dict(
        data_shape=[6, 128, 128, 1], timesteps=1000, beta_schedule="linear",
        use_ema=True, log_every_t=100, clip_denoised=False, linear_start=1e-4,
        linear_end=2e-2, cosine_s=8e-3, given_betas=None,
        original_elbo_weight=0.0, v_posterior=0.0, l_simple_weight=1.0,
        parameterization="eps", learn_logvar=True, logvar_init=0.0,
        latent_shape=[6, 16, 16, 64], cond_stage_model="__is_first_stage__",
        num_timesteps_cond=None, cond_stage_trainable=False,
        cond_stage_forward=None, scale_by_std=False, scale_factor=1.0,
        latent_cond_shape=[7, 16, 16, 64],
        decode_chunk_size=None,
        first_stage_dtype="auto",
    )


def latent_model_default() -> Dict:
    return dict(
        input_shape=[7, 16, 16, 64], target_shape=[6, 16, 16, 64],
        base_units=256, block_units=None, scale_alpha=1.0, num_heads=4,
        attn_drop=0.1, proj_drop=0.1, ffn_drop=0.1, downsample=2,
        downsample_type="patch_merge", upsample_type="upsample",
        upsample_kernel_size=3, depth=[4, 4], self_pattern="axial",
        num_global_vectors=0, use_dec_self_global=False,
        dec_self_update_global=True, use_dec_cross_global=False,
        use_global_vector_ffn=False, use_global_self_attn=True,
        separate_global_qkv=True, global_dim_ratio=1, ffn_activation="gelu",
        gated_ffn=False, norm_layer="layer_norm", padding_type="zeros",
        pos_embed_type="t+h+w", checkpoint_level=0, use_relative_pos=True,
        self_attn_use_final_proj=True,
        attn_linear_init_mode="0", ffn_linear_init_mode="0",
        ffn2_linear_init_mode="2", attn_proj_linear_init_mode="2",
        conv_init_mode="0", down_up_linear_init_mode="0",
        global_proj_linear_init_mode="2", norm_init_mode="0",
        time_embed_channels_mult=4,
        time_embed_use_scale_shift_norm=False, time_embed_dropout=0.0,
        unet_res_connect=True,
    )


def vae_default() -> Dict:
    return dict(
        pretrained_ckpt_path="pretrained_sevirlr_vae_8x8x64_v1.pt",
        data_channels=1,
        down_block_types=["DownEncoderBlock2D"] * 4,
        in_channels=1,
        block_out_channels=[128, 256, 512, 512],
        act_fn="silu",
        latent_channels=64,
        up_block_types=["UpDecoderBlock2D"] * 4,
        norm_num_groups=32,
        layers_per_block=2,
        out_channels=1,
        decoder_subpixel="auto",
    )


def align_default() -> Dict:
    return dict(
        alignment_type="avg_x",
        guide_scale=50.0,
        model_type="cuboid",
        model_args=dict(
            input_shape=[6, 16, 16, 64], out_channels=1, base_units=128,
            scale_alpha=1.0, depth=[1, 1], downsample=2,
            downsample_type="patch_merge", block_attn_patterns="axial",
            num_heads=4, attn_drop=0.1, proj_drop=0.1, ffn_drop=0.1,
            ffn_activation="gelu", gated_ffn=False, norm_layer="layer_norm",
            use_inter_ffn=True, hierarchical_pos_embed=False,
            pos_embed_type="t+h+w", padding_type="zeros", checkpoint_level=0,
            use_relative_pos=True, self_attn_use_final_proj=True,
            num_global_vectors=0, use_global_vector_ffn=True,
            use_global_self_attn=False, separate_global_qkv=False,
            global_dim_ratio=1,
            attn_linear_init_mode="0", ffn_linear_init_mode="0",
            ffn2_linear_init_mode="2", attn_proj_linear_init_mode="2",
            conv_init_mode="0", down_linear_init_mode="0",
            global_proj_linear_init_mode="2", norm_init_mode="0",
            time_embed_channels_mult=4,
            time_embed_use_scale_shift_norm=False, time_embed_dropout=0.0,
            pool="attention", readout_seq=True, out_len=6,
        ),
        model_ckpt_path="pretrained_sevirlr_alignment_avg_x_cuboid_v1.pt",
    )


def eval_default() -> Dict:
    return dict(
        train_example_data_idx_list=[0],
        val_example_data_idx_list=[0, 16, 32, 48, 64, 72, 96, 108, 128],
        test_example_data_idx_list=[0, 16, 32, 48, 64, 72, 96, 108, 128],
        eval_example_only=True, eval_aligned=True, eval_unaligned=True,
        num_samples_per_context=1, fs=20, label_offset=[-0.5, 0.5],
        label_avg_int=False, fvd_features=400, fvd=True, fvd_resolution=224,
        val_ddim_steps=50,
    )


def logging_default() -> Dict:
    return dict(logging_prefix="PreDiff", monitor_lr=True, monitor_device=False,
                track_grad_norm=-1, use_wandb=False, profiler=None, save_npy=True)


def trainer_default() -> Dict:
    return dict(check_val_every_n_epoch=50, log_step_ratio=0.001, precision=32,
                find_unused_parameters=False, num_sanity_val_steps=2)


def prediff_default_config() -> ConfigDict:
    """Full default tree == scripts/prediff/sevirlr/prediff_sevirlr_v1.yaml."""
    return ConfigDict.wrap(
        dict(
            dataset=dataset_default(),
            layout=layout_default(),
            optim=optim_default(),
            logging=logging_default(),
            trainer=trainer_default(),
            eval=eval_default(),
            model=dict(
                diffusion=diffusion_default(),
                align=align_default(),
                latent_model=latent_model_default(),
                vae=vae_default(),
            ),
        )
    )


def vae_training_default_config() -> ConfigDict:
    """Defaults matching scripts/vae/sevirlr/vae_sevirlr_v1.yaml."""
    return ConfigDict.wrap(
        dict(
            dataset=deep_merge(dataset_default(), dict(
                aug_mode="1", in_len=0, out_len=1, seq_len=1, stride=1,
            )),
            layout=deep_merge(layout_default(), dict(layout="NHWC")),
            optim=deep_merge(optim_default(), dict(lr=5.0e-5, total_batch_size=128,
                                                   micro_batch_size=8)),
            logging=logging_default(),
            trainer=trainer_default(),
            eval=eval_default(),
            model=dict(
                vae=vae_default(),
                loss=dict(
                    disc_start=50001, kl_weight=1e-6, disc_weight=0.5,
                    disc_factor=1.0, disc_loss="hinge", logvar_init=0.0,
                    perceptual_weight=0.0, disc_in_channels=1,
                    disc_num_layers=3, use_actnorm=False,
                ),
            ),
        )
    )


def alignment_default_config() -> ConfigDict:
    return ConfigDict.wrap(
        dict(
            dataset=dataset_default(),
            layout=layout_default(),
            optim=deep_merge(optim_default(), dict(lr=1.0e-4)),
            logging=logging_default(),
            trainer=trainer_default(),
            eval=eval_default(),
            model=dict(
                diffusion=diffusion_default(),
                align=align_default(),
                vae=vae_default(),
            ),
        )
    )


def load_config(default_fn, yaml_path: Optional[str] = None) -> ConfigDict:
    cfg = default_fn().to_dict()
    if yaml_path:
        cfg = deep_merge(cfg, load_yaml(yaml_path))
    return ConfigDict.wrap(cfg)
