"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  A wrapper takes the plain version only for tensors on the CPU;
a CUDA tensor launches the kernel or raises."""
from repro_torch.kernels._build import launch_counts, reset_launch_counts  # noqa: F401
