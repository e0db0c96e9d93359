"""Earthformer cuboid-transformer UNet, the latent diffusion denoiser.

Input: noisy latent x (B, T_out, H, W, C) and conditioning latent
(B, T_in, H, W, C), concatenated along T with a 0/1 observation-indicator
channel; output: the prediction over the last T_out frames.  NTHWC end to
end.  Each stage's time block is one module called ``depth`` times, as in
the JAX package, so those weights are shared the same way.  The variants the
JAX UNet builds from its configuration are the layers' (``ffn_activation``,
``gated_ffn``, ``use_inter_ffn``, ``pos_embed_type``, ``use_relative_pos``,
``self_attn_use_final_proj``, ``time_embed_use_scale_shift_norm``, the init
modes) and global vectors: ``num_global_vectors`` vectors of width
``global_dim_ratio * base_units`` (``init_global_vectors``, broadcast over
the batch) threaded through every block, projected to each stage's width by
``down_layer_global_proj`` / ``up_layer_global_proj``; and
``hierarchical_pos_embed``, a position embedding after each patch merge and
upsample.  ``use_pallas_conv`` sends the 3x3x3 convs of
``first_proj`` and the time blocks to the bf16 conv kernel where the JAX
package's routing rule admits the call (``TimeEmbedResBlock``).

Training: every kernel's ``autograd.Function`` gives its parameter gradients
from its all-gradients kernel when they are asked for (the parameters
require grad) and dx alone when they are not.  Dropout (``attn_drop`` on the
attention weights, ``proj_drop`` on each attention layer's output and in
``first_proj``, ``ffn_drop`` on the FFN's activation and output,
``time_embed_dropout`` in the time blocks) is active in training mode only:
the forward then takes the step's ``dropout_seed``, and every module call
that drops takes the next site of one :class:`~prediff_torch.ops.dropout.
DropoutStream`, in call order, so each call's masks are a function of
(seed, site) that its backward regenerates; on several ranks the forward
takes the rank's first global batch row too (``dropout_first_row``), so its
masks are its rows of the one-process masks.  Eval mode ignores the rates.

Rematerialization (``remat``, which ``DiffusionTrainer(remat_unet=True)`` sets
for its training steps): in training mode with autograd recording, each
(time block, self block) pair is one non-reentrant ``torch.utils.checkpoint``
segment whose activations the backward recomputes; a segment replays its
dropout sites from the stream's site at its entry (``DropoutStream.fork``), so
the recompute draws the masks the forward drew and the gradients keep their
bits; in a captured micro-step (``training/step_graphs.py``) the recompute
runs inside the captured backward, on the graph's pool, from the same sites.
The forecast path never sets it.

``attention_kernels``, ``ffn_kernel`` and ``gn_kernel`` are the
configuration's ``use_pallas_attention`` / ``use_pallas_ffn`` /
``use_pallas_gn`` as ``factory.build_unet`` reads them: with ``False`` the
layers take their library routes (f32), as the JAX layers do.  The UNet's time
blocks run unfused whatever ``use_pallas_resblock`` says.
"""
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.dropout import DropoutStream
from .cuboid_attention import StackCuboidSelfAttentionBlock
from .init import with_init
from .layers import (PatchMerging3D, PosEmbed, TimeEmbedLayer, TimeEmbedResBlock,
                     Upsample3DLayer, timestep_embedding)
from .patterns import block_patterns


def _recomputed(fn, drop: Optional[DropoutStream], *args):
    """``fn(*args, stream)`` as one non-reentrant checkpoint segment: the
    stream a fork of ``drop`` at its site on entry, on the first run and on
    the recompute alike, ``drop`` then moved past the sites the segment took.
    ``preserve_rng_state`` is off: the forward draws nothing from torch's
    global generators."""
    if drop is None:
        return checkpoint(fn, *args, None, use_reentrant=False, preserve_rng_state=False)
    site, end = drop.site, []

    def run(*a):
        stream = drop.fork(site)
        out = fn(*a, stream)
        end.append(stream.site)
        return out

    out = checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
    drop.site = end[0]
    return out


def round_to(dat: int, c: int) -> int:
    return dat + (dat - dat % c) % c


def _normalize_downsample(downsample) -> Tuple[int, int, int]:
    if not isinstance(downsample, (tuple, list)):
        return (1, downsample, downsample)
    return tuple(downsample)


def compute_block_units(base_units, num_blocks, downsample, scale_alpha):
    downsample = _normalize_downsample(downsample)
    return [round_to(base_units * int((max(downsample) ** scale_alpha) ** i), 4)
            for i in range(num_blocks)]


def compute_mem_shapes(data_shape, base_units, num_blocks, downsample, block_units):
    """Per-stage (T, H, W, C) feature shapes after each patch merge."""
    downsample = _normalize_downsample(downsample)
    curr = tuple(data_shape[:3]) + (base_units,)
    mem_shapes = [curr]
    for i in range(num_blocks - 1):
        curr = PatchMerging3D.get_out_shape(curr, downsample, block_units[i + 1])
        mem_shapes.append(curr)
    return mem_shapes


class CuboidTransformerUNet(nn.Module):
    def __init__(self, input_shape, target_shape, base_units: int = 128,
                 block_units: Optional[Sequence[int]] = None, scale_alpha: float = 1.0,
                 depth: Sequence[int] = (4, 4), downsample: Union[int, Tuple] = 2,
                 block_attn_patterns: Union[str, Sequence[str]] = "axial", num_heads: int = 4,
                 padding_type: str = "ignore", upsample_kernel_size: int = 3,
                 time_embed_channels_mult: int = 4, unet_res_connect: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, ffn_drop: float = 0.0,
                 time_embed_dropout: float = 0.0, use_pallas_conv: bool = False,
                 attention_kernels: str = "layer", ffn_kernel: bool = True,
                 gn_kernel: bool = True, ffn_activation: str = "gelu", gated_ffn: bool = False,
                 use_inter_ffn: bool = True, hierarchical_pos_embed: bool = False,
                 pos_embed_type: str = "t+h+w", use_relative_pos: bool = True,
                 self_attn_use_final_proj: bool = True, num_global_vectors: int = 0,
                 use_global_vector_ffn: bool = True, use_global_self_attn: bool = False,
                 separate_global_qkv: bool = False, global_dim_ratio: int = 1,
                 time_embed_use_scale_shift_norm: bool = False, attn_linear_init_mode: str = "0",
                 ffn_linear_init_mode: str = "0", ffn2_linear_init_mode: str = "2",
                 attn_proj_linear_init_mode: str = "2", conv_init_mode: str = "0",
                 down_linear_init_mode: str = "0", global_proj_linear_init_mode: str = "2"):
        super().__init__()
        self.remat = False   # recompute each block pair in the backward (module docstring)
        self.dropout_rates = dict(attn_drop=attn_drop, proj_drop=proj_drop, ffn_drop=ffn_drop,
                                  time_embed_dropout=time_embed_dropout)
        T_in, H_in, W_in, C_in = input_shape
        T_out, H_out, W_out, C_out = target_shape
        if (H_in, W_in, C_in) != (H_out, W_out, C_out):
            raise ValueError("input and target latents must share H, W, C")
        self.T_in = T_in
        self.data_shape = (T_in + T_out, H_in, W_in, C_in + 1)  # +1 obs indicator
        self.num_blocks = len(depth)
        self.depth = list(depth)
        self.unet_res_connect = unet_res_connect
        downsample = _normalize_downsample(downsample)
        if block_units is None:
            block_units = compute_block_units(base_units, self.num_blocks, downsample, scale_alpha)
        self.block_units = list(block_units)
        mem_shapes = compute_mem_shapes(self.data_shape, base_units, self.num_blocks, downsample,
                                        self.block_units)
        self.mem_shapes = mem_shapes
        patterns = block_patterns(block_attn_patterns, self.num_blocks)
        tec = self.block_units[0] * time_embed_channels_mult

        self.first_proj = TimeEmbedResBlock(self.data_shape[-1], base_units, use_embed=False,
                                            dropout=proj_drop, conv_kernel=use_pallas_conv,
                                            gn_kernel=gn_kernel)
        self.num_global_vectors = num_global_vectors
        gdims = [global_dim_ratio * u for u in self.block_units]
        if num_global_vectors:
            self.init_global_vectors = nn.Parameter(torch.zeros(num_global_vectors, gdims[0]))
        self.pos_embed = PosEmbed(base_units, *self.data_shape[:3], typ=pos_embed_type)
        self.time_embed = TimeEmbedLayer(self.block_units[0], tec)
        self.hierarchical_pos_embed = hierarchical_pos_embed

        def stack(i):
            cuboid_size, strategy, shift_size = patterns[i](mem_shapes[i])
            return StackCuboidSelfAttentionBlock(
                mem_shapes[i][-1], num_heads, cuboid_size, shift_size, strategy, attn_drop,
                proj_drop, ffn_drop, padding_type, attention_kernels, ffn_kernel,
                activation=ffn_activation, gated_ffn=gated_ffn, use_inter_ffn=use_inter_ffn,
                use_global_vector=num_global_vectors > 0,
                use_global_vector_ffn=use_global_vector_ffn,
                use_global_self_attn=use_global_self_attn,
                separate_global_qkv=separate_global_qkv, global_dim_ratio=global_dim_ratio,
                use_relative_pos=use_relative_pos, use_final_proj=self_attn_use_final_proj,
                attn_linear_init_mode=attn_linear_init_mode,
                ffn_linear_init_mode=ffn_linear_init_mode,
                ffn2_linear_init_mode=ffn2_linear_init_mode,
                attn_proj_linear_init_mode=attn_proj_linear_init_mode)

        def time_block(i):
            return TimeEmbedResBlock(mem_shapes[i][-1], mem_shapes[i][-1], emb_channels=tec,
                                     dropout=time_embed_dropout, conv_kernel=use_pallas_conv,
                                     gn_kernel=gn_kernel,
                                     use_scale_shift_norm=time_embed_use_scale_shift_norm)


        self.down_time_embed_blocks = nn.ModuleList(time_block(i) for i in range(self.num_blocks))
        self.down_self_blocks = nn.ModuleList(
            nn.ModuleList(stack(i) for _ in range(self.depth[i])) for i in range(self.num_blocks))
        self.downsample_layers = nn.ModuleList(
            PatchMerging3D(mem_shapes[i][-1], self.block_units[i + 1], downsample, padding_type,
                           down_linear_init_mode)
            for i in range(self.num_blocks - 1))
        stages = range(1, self.num_blocks)
        if hierarchical_pos_embed:   # after the merge into stage i, after the upsample into i - 1
            self.down_hierarchical_pos_embed_l = nn.ModuleList(
                PosEmbed(self.block_units[i], *mem_shapes[i][:3], typ=pos_embed_type)
                for i in stages)
            self.up_hierarchical_pos_embed_l = nn.ModuleList(
                PosEmbed(self.block_units[i - 1], *mem_shapes[i - 1][:3], typ=pos_embed_type)
                for i in stages)
        if num_global_vectors:   # the global vectors into stage i, and back into i - 1
            self.down_layer_global_proj = nn.ModuleList(
                with_init(nn.Linear(gdims[i - 1], gdims[i]), global_proj_linear_init_mode)
                for i in stages)
            self.up_layer_global_proj = nn.ModuleList(
                with_init(nn.Linear(gdims[i], gdims[i - 1]), global_proj_linear_init_mode)
                for i in stages)
        self.up_time_embed_blocks = nn.ModuleList(time_block(i) for i in range(self.num_blocks))
        self.up_self_blocks = nn.ModuleList(
            nn.ModuleList(stack(i) for _ in range(self.depth[i])) for i in range(self.num_blocks))
        self.upsample_layers = nn.ModuleList(
            Upsample3DLayer(mem_shapes[i + 1][-1], mem_shapes[i][-1], mem_shapes[i][:3],
                            upsample_kernel_size, conv_init_mode)
            for i in range(self.num_blocks - 1))
        self.final_proj = nn.Linear(base_units, C_out)

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                dropout_seed=None, dropout_first_row: int = 0) -> torch.Tensor:
        """x (B, T_out, H, W, C) noisy latent; t (B,); cond (B, T_in, H, W, C).
        ``dropout_seed`` (a host integer, up to 64 bits, or a device seed of
        ``ops/dropout.py``) seeds this forward's dropout masks; training mode with a rate above 0 needs it, eval mode
        ignores it.  ``dropout_first_row``: the global batch row of x's first
        row (a rank's on several), from which the masks are drawn."""
        drop = None
        if self.training and any(v and v > 0 for v in self.dropout_rates.values()):
            if dropout_seed is None:
                raise ValueError("training mode with dropout "
                                 f"{ {k: v for k, v in self.dropout_rates.items() if v} } "
                                 "needs dropout_seed; call .eval() to forecast")
            drop = DropoutStream(dropout_seed, dropout_first_row)
        x = torch.cat([cond, x], dim=1)
        obs = torch.zeros_like(x[..., :1])
        obs[:, :self.T_in] = 1.0
        x = self.first_proj(torch.cat([x, obs], dim=-1), drop=drop)
        gv = None
        if self.num_global_vectors:
            gv = self.init_global_vectors[None].expand(x.shape[0], -1, -1)
        x = self.pos_embed(x)
        t_emb = self.time_embed(timestep_embedding(t, self.block_units[0]).to(x.dtype))

        def pair(time_block, block, x, gv, drop):
            x = time_block(x, t_emb, drop)
            if gv is None:
                return block(x, drop), None
            return block(x, drop, gv)

        remat = self.remat and self.training and torch.is_grad_enabled()

        def blocks(time_block, self_blocks, x, gv):
            for block in self_blocks:
                if remat:
                    x, gv = _recomputed(pair, drop, time_block, block, x, gv)
                else:
                    x, gv = pair(time_block, block, x, gv, drop)
            return x, gv

        res_connect = []
        for i in range(self.num_blocks):
            if i > 0:
                x = self.downsample_layers[i - 1](x)
                if self.hierarchical_pos_embed:
                    x = self.down_hierarchical_pos_embed_l[i - 1](x)
                if gv is not None:
                    gv = self.down_layer_global_proj[i - 1](gv)
            x, gv = blocks(self.down_time_embed_blocks[i], self.down_self_blocks[i], x, gv)
            if self.unet_res_connect and i < self.num_blocks - 1:
                res_connect.append(x)
        for i in range(self.num_blocks - 1, -1, -1):
            if self.unet_res_connect and i < self.num_blocks - 1:
                x = x + res_connect[i]
            x, gv = blocks(self.up_time_embed_blocks[i], self.up_self_blocks[i], x, gv)
            if i > 0:
                x = self.upsample_layers[i - 1](x)
                if self.hierarchical_pos_embed:
                    x = self.up_hierarchical_pos_embed_l[i - 1](x)
                if gv is not None:
                    gv = self.up_layer_global_proj[i - 1](gv)
        return self.final_proj(x[:, self.T_in:])
