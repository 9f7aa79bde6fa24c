"""Wrappers of the port's hand-written CUDA kernels (``csrc/``) and their
build (``build.py``). Each wrapper runs its kernel's plain PyTorch version
on CPU tensors and launches the kernel on CUDA tensors; it counts its
launches in ``launches`` on the launching function."""
