"""Knowledge-alignment network U(z_t, t): a half-UNet cuboid encoder with a
CLIP-style attention-pool readout, channel-last like the rest of the port.

Counterpart of ``prediff_tpu/models/alignment.py`` (reference
NoisyCuboidTransformerEncoder, models.py:107; AttentionPool3d, :49).  The
stage time blocks run the whole-resblock kernels (``fused=True``), as the
JAX package's ``use_pallas_resblock`` does for this network (unfused with
``resblock_kernel=False``, its ``use_pallas_resblock: false``); ``first_proj``
changes width (1x1 skip) and keeps the GN-kernel path, with its 3x3x3 convs
on the bf16 conv kernel under ``use_pallas_conv`` where the JAX package's
routing rule admits them (the stage blocks' resblock kernel comes first, as
in the JAX package; a block with ``time_embed_use_scale_shift_norm`` is never
fused, as there).  The variants the JAX net builds from its configuration are
the layers' (as the UNet's), ``hierarchical_pos_embed`` (a position embedding
after each patch merge), global vectors (as the UNet's, the readout's tokens
ending with them: per frame, each frame's tokens then the N vectors) and the
pooled readout (``readout_seq=False``: one attention pool over all of T,
(B, out_channels)).  The modules carry the
configuration's dropout rates: eval mode (guidance) ignores them, training
mode (``training.AlignmentTrainer``) takes the forward's dropout seed and
runs the FFN and attention layers' dropout kernels, as the UNet does.
"""
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import DropoutStream
from .cuboid_attention import StackCuboidSelfAttentionBlock
from .init import with_init
from .layers import (PatchMerging3D, PosEmbed, TimeEmbedLayer, TimeEmbedResBlock, conv_nthwc,
                     timestep_embedding)
from .patterns import block_patterns
from .unet import _normalize_downsample, compute_block_units, compute_mem_shapes


class AttentionPool3d(nn.Module):
    """Mean token + learned positional embedding + one QKV attention, read
    out at token 0.  Input (N, L, C); ``qkv_proj`` and ``c_proj`` are 1x1
    ``Conv1d``s as in the reference; softmax in f32, q and k both scaled by
    ch**-0.25."""
    # seeded initialisation: flax's default (lecun_normal), as the JAX pool's nn.Conv
    FLAX_DEFAULT_INIT = True

    def __init__(self, data_dim: int, embed_dim: int, num_heads: int,
                 output_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.zeros(embed_dim, data_dim + 1))
        self.qkv_proj = nn.Conv1d(embed_dim, 3 * embed_dim, 1)
        self.c_proj = nn.Conv1d(embed_dim, output_dim or embed_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, L, C = x.shape
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding.T[None]
        q, k, v = conv_nthwc(self.qkv_proj, x).chunk(3, dim=-1)
        heads = self.num_heads
        ch = C // heads
        scale = 1.0 / ch ** 0.25
        q = q.reshape(N, L + 1, heads, ch) * scale
        k = k.reshape(N, L + 1, heads, ch) * scale
        v = v.reshape(N, L + 1, heads, ch)
        w = torch.einsum("bihc,bjhc->bhij", q, k)
        w = torch.softmax(w.float(), dim=-1).to(w.dtype)
        a = torch.einsum("bhij,bjhc->bihc", w, v).reshape(N, L + 1, C)
        return conv_nthwc(self.c_proj, a)[:, 0]


class NoisyCuboidTransformerEncoder(nn.Module):
    """Encoder-only cuboid transformer over noisy latents with a per-frame
    attention-pool readout (the reference's ``readout_seq``):
    (B, T, H, W, C), (B,) -> (B, out_len, out_channels); with
    ``readout_seq=False`` one readout over all of T: (B, out_channels)."""

    def __init__(self, input_shape: Tuple[int, int, int, int], out_channels: int = 1,
                 base_units: int = 128, scale_alpha: float = 1.0,
                 depth: Sequence[int] = (4, 4, 4), downsample: Union[int, Tuple] = 2,
                 block_attn_patterns: Union[str, Sequence[str]] = "axial", num_heads: int = 4,
                 padding_type: str = "zeros", time_embed_channels_mult: int = 4,
                 out_len: Optional[int] = None, attn_drop: float = 0.0, proj_drop: float = 0.0,
                 ffn_drop: float = 0.0, time_embed_dropout: float = 0.0,
                 use_pallas_conv: bool = False, attention_kernels: str = "layer",
                 ffn_kernel: bool = True, gn_kernel: bool = True, resblock_kernel: bool = True,
                 ffn_activation: str = "gelu", gated_ffn: bool = False,
                 use_inter_ffn: bool = True, hierarchical_pos_embed: bool = False,
                 pos_embed_type: str = "t+h+w", use_relative_pos: bool = True,
                 self_attn_use_final_proj: bool = True, num_global_vectors: int = 0,
                 use_global_vector_ffn: bool = True, use_global_self_attn: bool = False,
                 separate_global_qkv: bool = False, global_dim_ratio: int = 1,
                 time_embed_use_scale_shift_norm: bool = False, readout_seq: bool = True,
                 attn_linear_init_mode: str = "0", ffn_linear_init_mode: str = "0",
                 ffn2_linear_init_mode: str = "2", attn_proj_linear_init_mode: str = "2",
                 down_linear_init_mode: str = "0", global_proj_linear_init_mode: str = "2"):
        super().__init__()
        self.dropout_rates = dict(attn_drop=attn_drop, proj_drop=proj_drop, ffn_drop=ffn_drop,
                                  time_embed_dropout=time_embed_dropout)
        self.input_shape = tuple(input_shape)
        self.num_blocks = len(depth)
        self.depth = list(depth)
        self.out_len = out_len
        self.out_channels = out_channels
        downsample = _normalize_downsample(downsample)
        self.block_units = compute_block_units(base_units, self.num_blocks, downsample,
                                               scale_alpha)
        mem_shapes = compute_mem_shapes(self.input_shape, base_units, self.num_blocks, downsample,
                                        self.block_units)
        self.mem_shapes = mem_shapes
        patterns = block_patterns(block_attn_patterns, self.num_blocks)
        tec = self.block_units[0] * time_embed_channels_mult

        self.first_proj = TimeEmbedResBlock(self.input_shape[-1], base_units, use_embed=False,
                                            dropout=proj_drop, conv_kernel=use_pallas_conv,
                                            gn_kernel=gn_kernel)
        self.num_global_vectors = num_global_vectors
        gdims = [global_dim_ratio * u for u in self.block_units]
        if num_global_vectors:
            self.init_global_vectors = nn.Parameter(torch.zeros(num_global_vectors, gdims[0]))
        self.pos_embed = PosEmbed(base_units, *self.input_shape[:3], typ=pos_embed_type)
        self.time_embed = TimeEmbedLayer(self.block_units[0], tec)
        self.downsample_layers = nn.ModuleList(
            PatchMerging3D(mem_shapes[i][-1], self.block_units[i + 1], downsample, padding_type,
                           down_linear_init_mode)
            for i in range(self.num_blocks - 1))
        stages = range(1, self.num_blocks)
        self.hierarchical_pos_embed = hierarchical_pos_embed
        if hierarchical_pos_embed:
            self.down_hierarchical_pos_embed_l = nn.ModuleList(
                PosEmbed(self.block_units[i], *mem_shapes[i][:3], typ=pos_embed_type)
                for i in stages)
        if num_global_vectors:
            self.down_layer_global_proj = nn.ModuleList(
                with_init(nn.Linear(gdims[i - 1], gdims[i]), global_proj_linear_init_mode)
                for i in stages)
        self.down_time_embed_blocks = nn.ModuleList(
            TimeEmbedResBlock(mem_shapes[i][-1], mem_shapes[i][-1], emb_channels=tec,
                              fused=resblock_kernel, dropout=time_embed_dropout,
                              gn_kernel=gn_kernel,
                              use_scale_shift_norm=time_embed_use_scale_shift_norm)
            for i in range(self.num_blocks))

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

        self.down_self_blocks = nn.ModuleList(
            nn.ModuleList(stack(i) for _ in range(self.depth[i])) for i in range(self.num_blocks))
        T_out, H_out, W_out, C_out = mem_shapes[-1]
        self.readout_seq = readout_seq
        tokens = (H_out * W_out if readout_seq else T_out * H_out * W_out) + num_global_vectors
        # index 1 is the reference's SiLU, applied with the GroupNorm in forward
        self.out = nn.Sequential(nn.GroupNorm(min(C_out, 32), C_out, eps=1e-5), nn.SiLU(),
                                 AttentionPool3d(tokens, C_out, num_heads, out_channels))

    def forward(self, x: torch.Tensor, t: torch.Tensor, dropout_seed: Optional[int] = None,
                dropout_first_row: int = 0) -> torch.Tensor:
        """``dropout_seed`` (a host integer, up to 64 bits) seeds this
        forward's dropout masks; training mode with a rate above 0 needs it,
        eval mode ignores it.  ``dropout_first_row``: the global batch row of
        x's first row (a rank's on several), from which the masks are
        drawn."""
        drop = None
        if self.training and any(v and v > 0 for v in self.dropout_rates.values()):
            if dropout_seed is None:
                raise ValueError("training mode with dropout "
                                 f"{ {k: v for k, v in self.dropout_rates.items() if v} } "
                                 "needs dropout_seed; call .eval() for guidance")
            drop = DropoutStream(dropout_seed, dropout_first_row)
        B = x.shape[0]
        x = self.first_proj(x, drop=drop)
        gv = None
        if self.num_global_vectors:
            gv = self.init_global_vectors[None].expand(B, -1, -1)
        x = self.pos_embed(x)
        t_emb = self.time_embed(timestep_embedding(t, self.block_units[0]).to(x.dtype))
        for i in range(self.num_blocks):
            if i > 0:
                x = self.downsample_layers[i - 1](x)
                if self.hierarchical_pos_embed:
                    x = self.down_hierarchical_pos_embed_l[i - 1](x)
                if gv is not None:
                    gv = self.down_layer_global_proj[i - 1](gv)
            for j in range(self.depth[i]):
                x = self.down_time_embed_blocks[i](x, t_emb, drop)
                if gv is None:
                    x = self.down_self_blocks[i][j](x, drop)
                else:
                    x, gv = self.down_self_blocks[i][j](x, drop, gv)
        C = x.shape[-1]
        if self.readout_seq:
            if self.out_len is not None:
                x = x[:, -self.out_len:]
            T_cur = x.shape[1]
            tokens = x.reshape(B * T_cur, -1, C)
            if gv is not None:   # each frame's tokens, then the global vectors
                tokens = torch.cat([tokens, gv.repeat(T_cur, 1, 1)], dim=1)
        else:
            tokens = x.reshape(B, -1, C)
            if gv is not None:
                tokens = torch.cat([tokens, gv], dim=1)
        norm, pool = self.out[0], self.out[2]
        # the readout's GroupNorm + SiLU are library calls, as the JAX net's flax ops are
        tokens = F.silu(F.group_norm(tokens.transpose(1, 2), norm.num_groups, norm.weight,
                                     norm.bias, norm.eps)).transpose(1, 2)
        if not self.readout_seq:
            return pool(tokens)
        return pool(tokens).reshape(B, T_cur, self.out_channels)
