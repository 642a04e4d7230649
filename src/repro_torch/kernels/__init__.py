"""The hand-written CUDA kernels for Hopper (attention, the SSD scan and
their backwards) and their plain PyTorch versions."""
