"""Search ops of the port: plain PyTorch reference ops and CUDA kernels."""
