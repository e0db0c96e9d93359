"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

A wrapper takes the plain version for a tensor on the CPU and launches its
kernel for a CUDA tensor, raising on what the kernel does not take."""
