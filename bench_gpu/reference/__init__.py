"""The plain float64 reference of the benchmark's cells: NumPy, SciPy and
plain PyTorch only. It imports neither jax, tpudsp nor anything of
tpudsp_torch, designs its own filters (``designs``) and takes nothing the
program made: the harness hands it the same wire blocks it handed the
program, and it reads the program's outputs only to judge them.
"""
