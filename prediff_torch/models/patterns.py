"""Cuboid attention patterns: a mem shape (T, H, W, C) -> per-layer
(cuboid_size, strategy, shift_size) lists.  The port carries the pattern the
v1 UNet uses."""


def self_axial(input_shape):
    """Axial attention: attend along T, then H, then W."""
    T, H, W, _ = input_shape
    cuboid_size = [(T, 1, 1), (1, H, 1), (1, 1, W)]
    strategy = [("l", "l", "l")] * 3
    shift_size = [(0, 0, 0)] * 3
    return cuboid_size, strategy, shift_size


CuboidSelfAttentionPatterns = {"axial": self_axial}
