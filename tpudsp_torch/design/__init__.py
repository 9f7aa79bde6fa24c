"""Host-side filter design (float64 NumPy/SciPy), copied from
``tpudsp.design`` so the port needs no JAX import to design its taps."""
