"""PyTorch port of the FCN3 reproduction (CUDA kernels for Hopper)."""
