"""PyTorch/CUDA port of the immediate-access dynamic index."""
