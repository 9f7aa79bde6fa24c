"""The benchmark of tpudsp_torch, the PyTorch and CUDA port, on NVIDIA
H100 cards: ``python3 bench_gpu/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and
prints its result as the last line of standard output.

Everything of one configuration, traffic mix, cell, hand kernel or
per-layer metric is a file of its own that ``registry`` finds by name:
``configs/``, ``traffic/``, ``cells/``, ``kernels/``, ``metrics/``; the
program's entries are driven by ``entries/<entry>.py``. The plain float64
reference that decides ``correct`` is ``reference/``.
"""
