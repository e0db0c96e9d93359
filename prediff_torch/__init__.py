"""PreDiff on PyTorch + CUDA (NVIDIA Hopper).

The PyTorch port of ``prediff_tpu``: the same module layout and names, the
same NTHWC layout at every public function, and one hand-written CUDA kernel
for each Pallas kernel of the JAX package (``prediff_torch/ops``).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
