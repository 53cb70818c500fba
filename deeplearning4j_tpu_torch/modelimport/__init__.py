"""Import of DL4J checkpoints into the PyTorch/CUDA port."""
