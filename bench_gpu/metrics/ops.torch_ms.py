"""ops.torch_ms: device time a block in everything that is not one of the
port's hand kernels (kernels/*.json): PyTorch's kernels (torch.fft, the
eager elementwise passes), copies and sets, from the profiler's device
events."""


def read(ctx):
    tr = ctx["trace"]
    total = sum(c[1] for c in tr["ops"].values())
    hand = sum(h["seconds"] for h in tr["hand"].values())
    return (total - hand) * 1e3 / ctx["blocks"]
