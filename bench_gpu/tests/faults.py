"""Faults planted underneath a run for test_bench_gpu_faults: each wraps
the program an entry builds."""

from __future__ import annotations


class _Wrapped:
    def __init__(self, prog, fn):
        self.prog, self.fn = prog, fn
        self.prefix_blocks = prog.prefix_blocks
        self.target = prog.target

    def work(self):
        return self.prog.work()

    def __call__(self, block):
        return self.fn(self.prog, block)


def _state_unchanged(prog, block):
    st = prog.target.state
    out = prog(block)
    prog.target.state = st
    return out


def state_unchanged(prog):
    """A step that returns its state unchanged."""
    return _Wrapped(prog, _state_unchanged)


def _half_left_out(prog, block):
    out = prog(block).clone()
    if out.ndim == 2:
        out[out.shape[0] // 2:] = 0.0      # half of the channels
    else:
        out[out.shape[0] // 2:] = 0.0      # half of the block's samples
    return out


def half_left_out(prog):
    """Half of the batch (the bank's channels, the chain's samples) left out."""
    return _Wrapped(prog, _half_left_out)


def _answer_altered(prog, block):
    out = prog(block).clone()
    out.view(-1)[out.numel() // 3] += 1.0
    return out


def answer_altered(prog):
    """One output sample altered where it is produced."""
    return _Wrapped(prog, _answer_altered)

