"""Decode engine of crackle_tpu_torch: host glue, replay and CCL
kernels (CUDA C++ in ../csrc) with their plain PyTorch versions, and
the device CRC32C gate."""
