"""am_front_scan's dependent-step counter (``_launch.steps``, read by the
``am_front_scan.ns_per_step`` metric) on the card: a chunked launch adds
its chunk and warmup, the exact launch its length."""

from __future__ import annotations

import pytest


@pytest.mark.card
def test_am_front_scan_counts_its_dependent_steps():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card with "
                    "python3 -m pytest bench_gpu/tests -m card")
    from tpudsp_torch.cuda import am_backend_scan as scan
    from tpudsp_torch.kernels import agc as kagc
    from tpudsp_torch.kernels import am_backend as kab
    from tpudsp_torch.kernels.pll import PllState

    dev = torch.device("cuda")
    C, L, chunk, warmup = 2, 5000, 1000, 500
    p = kab.make_params(kagc.make_params(alpha=0.01, device=dev), 1.0, 0.1, 0.9,
                        carrier=True)
    zeros = lambda: torch.zeros((C,), dtype=torch.float32, device=dev)
    st = kab.FrontState(
        agc=kagc.AgcState(*(v.expand(C).contiguous() for v in kagc.agc_init(device=dev))),
        pll=PllState(zeros(), zeros()))
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.complex(torch.randn(C, L, device=dev, generator=g),
                      torch.randn(C, L, device=dev, generator=g))

    launches, steps = scan._launch.launches, scan._launch.steps
    scan.front_chunked(p, st, x, chunk, warmup)          # 5 whole chunks a stream
    assert scan._launch.launches - launches == 1
    assert scan._launch.steps - steps == chunk + warmup

    launches, steps = scan._launch.launches, scan._launch.steps
    scan.front_exact(p, st, x[:, :700])
    torch.cuda.synchronize()
    assert scan._launch.launches - launches == 1
    assert scan._launch.steps - steps == 700
