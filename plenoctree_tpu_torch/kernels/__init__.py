"""Python wrappers of the hand-written CUDA kernels in `csrc/`.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch version for CPU tensors, and counts its launches.
"""
