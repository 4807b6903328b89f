"""Hand-written CUDA kernels: the nvcc build and each kernel's wrapper."""
