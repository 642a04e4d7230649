"""The plain reference of the configurations: plain PyTorch, float32
with TF32 off, no kernel, cache or batching, and nothing of the port."""
