"""Cuboid self-attention patterns: a mem shape (T, H, W, C) -> per-layer
(cuboid_size, strategy, shift_size) lists, under the names Earthformer's
``cuboid_transformer_patterns.py`` registers, and the cross-attention
patterns (:data:`CuboidCrossAttentionPatterns`: a memory shape -> per-layer
(cuboid_hw, shift_hw, strategy, n_temporal)), which no model of either
package uses: they are here so that the public registries match the JAX
package's."""
import functools


def full_attention(input_shape):
    T, H, W, _ = input_shape
    return [(T, H, W)], [("l", "l", "l")], [(0, 0, 0)]


def self_axial(input_shape):
    """Axial attention: attend along T, then H, then W."""
    T, H, W, _ = input_shape
    cuboid_size = [(T, 1, 1), (1, H, 1), (1, 1, W)]
    strategy = [("l", "l", "l")] * 3
    shift_size = [(0, 0, 0)] * 3
    return cuboid_size, strategy, shift_size


def self_video_swin(input_shape, P=2, M=4):
    """Video Swin: two local windows, the second shifted by half."""
    T, H, W, _ = input_shape
    P = min(P, T)
    M = min(M, H, W)
    cuboid_size = [(P, M, M), (P, M, M)]
    strategy = [("l", "l", "l"), ("l", "l", "l")]
    shift_size = [(0, 0, 0), (P // 2, M // 2, M // 2)]
    return cuboid_size, strategy, shift_size


def self_divided_space_time(input_shape):
    T, H, W, _ = input_shape
    cuboid_size = [(T, 1, 1), (1, H, W)]
    strategy = [("l", "l", "l"), ("l", "l", "l")]
    shift_size = [(0, 0, 0), (0, 0, 0)]
    return cuboid_size, strategy, shift_size


def self_spatial_lg_v1(input_shape, M=4):
    """Axial in time, then local and dilated M x M windows in space."""
    T, H, W, _ = input_shape
    if H <= M and W <= M:
        cuboid_size = [(T, 1, 1), (1, H, W)]
        strategy = [("l", "l", "l"), ("l", "l", "l")]
        shift_size = [(0, 0, 0), (0, 0, 0)]
    else:
        cuboid_size = [(T, 1, 1), (1, M, M), (1, M, M)]
        strategy = [("l", "l", "l"), ("l", "l", "l"), ("d", "d", "d")]
        shift_size = [(0, 0, 0), (0, 0, 0), (0, 0, 0)]
    return cuboid_size, strategy, shift_size


def self_axial_space_dilate_K(input_shape, K=2):
    T, H, W, _ = input_shape
    K = min(K, H, W)
    cuboid_size = [(T, 1, 1), (1, H // K, 1), (1, H // K, 1), (1, 1, W // K), (1, 1, W // K)]
    strategy = [("l", "l", "l"), ("d", "d", "d"), ("l", "l", "l"), ("d", "d", "d"),
                ("l", "l", "l")]
    shift_size = [(0, 0, 0)] * 5
    return cuboid_size, strategy, shift_size


CuboidSelfAttentionPatterns = {"full": full_attention, "axial": self_axial,
                               "video_swin": self_video_swin,
                               "divided_st": self_divided_space_time}
for _p in (1, 2, 4, 8, 10):
    for _m in (1, 2, 4, 8, 16, 32):
        CuboidSelfAttentionPatterns[f"video_swin_{_p}x{_m}"] = functools.partial(
            self_video_swin, P=_p, M=_m)
CuboidSelfAttentionPatterns["spatial_lg_v1"] = self_spatial_lg_v1
for _m in (1, 2, 4, 8, 16, 32):
    CuboidSelfAttentionPatterns[f"spatial_lg_{_m}"] = functools.partial(self_spatial_lg_v1, M=_m)
for _k in (2, 4, 8):
    CuboidSelfAttentionPatterns[f"axial_space_dilate_{_k}"] = functools.partial(
        self_axial_space_dilate_K, K=_k)


def cross_KxK(mem_shape, K):
    T_mem, H, W, _ = mem_shape
    K = min(K, H, W)
    return [(K, K)], [(0, 0)], [("l", "l", "l")], [1]


def cross_KxK_lg(mem_shape, K):
    T_mem, H, W, _ = mem_shape
    K = min(K, H, W)
    return [(K, K), (K, K)], [(0, 0), (0, 0)], [("l", "l", "l"), ("d", "d", "d")], [1, 1]


def cross_KxK_heter(mem_shape, K):
    T_mem, H, W, _ = mem_shape
    K = min(K, H, W)
    cuboid_hw = [(K, K)] * 3
    shift_hw = [(0, 0), (0, 0), (K // 2, K // 2)]
    strategy = [("l", "l", "l"), ("d", "d", "d"), ("l", "l", "l")]
    return cuboid_hw, shift_hw, strategy, [1, 1, 1]


CuboidCrossAttentionPatterns = {}
for _k in (1, 2, 4, 8):
    CuboidCrossAttentionPatterns[f"cross_{_k}x{_k}"] = functools.partial(cross_KxK, K=_k)
    CuboidCrossAttentionPatterns[f"cross_{_k}x{_k}_lg"] = functools.partial(cross_KxK_lg, K=_k)
    CuboidCrossAttentionPatterns[f"cross_{_k}x{_k}_heter"] = functools.partial(cross_KxK_heter,
                                                                              K=_k)


def block_patterns(names, num_blocks: int):
    """The pattern function of each of ``num_blocks`` stages from one
    registered name, or one name per stage."""
    names = [names] * num_blocks if isinstance(names, str) else list(names)
    if len(names) != num_blocks:
        raise ValueError(f"{len(names)} attention patterns for {num_blocks} stages")
    return [CuboidSelfAttentionPatterns[n] for n in names]
