"""The 16-channel receiver bank (BASELINE config 3) against the benchmark's
float64 reference ``bench_gpu/reference/receiver_bank.py``, on the CPU at a
small size: the port's plain versions (``cfir_ref``, the plain scan) over
three blocks of a seeded ring on the cell ``bank16.fm.c64.b8m``'s channel
grid, the reference's controls, the chain's stage spans, and the front
end's roofline formula at the cell's shape."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from bench_gpu import calibrate, registry, signals
from bench_gpu.reference import precision, receiver_bank
from bench_gpu.reference.precision import CONTROLS
from tpudsp_torch.utils.profiling import record_spans, reset_spans, span_table

CELL = "bank16.fm.c64.b8m"
N = 100_000          # three blocks of 100,000 samples (2,000 pcm a channel each)
SMALL = {"traffic": {"block_len": 25_000, "ring_blocks": 2}}   # the controls' size
SEED = 2**31 + 4242


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test's tensors are small, and beside the
    suite's other workers a thread pool the size of the machine spends its
    time waiting for its threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell():
    c = registry.workload(CELL)
    return c, registry.config(c["config"]), registry.traffic(c["traffic"])


def _limit() -> float:
    return registry.workload(CELL)["params"]["limit_worst_ch_err_db"]


def _worst_db(got, ref) -> float:
    e = np.sum((got - ref) ** 2, axis=1) / np.sum(ref ** 2, axis=1)
    return float(10 * np.log10(np.max(e)))


def _program(cfg, mix):
    ent = registry.entry("receiver_bank")
    return ent.build(cfg, {"judge_prefix_s": 0.0}, mix, torch.device("cpu"))


def test_the_cell_loads_with_every_file():
    c, cfg, mix = _cell()
    assert c["config"] == cfg["name"] == "bank16-2400ksps" and cfg["reduced"] == []
    assert mix["format"] == "c64" and mix["signal"] == "fm" and mix["channels"] == 16
    assert mix["block_len"] % (cfg["bank"]["decim1"] * cfg["bank"]["decim2"]) == 0
    # the channels sit on the generator's grid, c iq_rate / channels
    grid = np.arange(16) * mix["iq_rate"] / 16
    got = np.mod(cfg["bank"]["freqs"], mix["iq_rate"])
    np.testing.assert_array_equal(got, grid)
    ent = registry.entry(c["entry"])
    assert callable(ent.build) and callable(ent.reference) and callable(ent.judge)
    names = [m["name"] for m in c["per_layer"]]
    assert "halo_async_roofline" in names
    for m in c["per_layer"]:
        assert callable(registry.metric(m["name"]).read)


@pytest.mark.parametrize("fmt", ["c64", "i16"])
def test_the_port_against_the_reference_across_blocks(fmt):
    """Three blocks from the zero state against the reference run from the
    stream's start, inside the cell's limit on the worst channel (the
    harness's judge of a pair after a prefix: the faults test below)."""
    _, cfg, mix = _cell()
    mix = dict(mix, block_len=N, ring_blocks=3, format=fmt)
    ring = signals.make_ring(mix, SEED, "cpu")
    prog = _program(cfg, mix)
    got = np.concatenate([prog(ring[g]).numpy() for g in range(3)], axis=1)
    x = np.concatenate([signals.to_complex(ring[g]) for g in range(3)])
    ent = registry.entry("receiver_bank")
    ref = receiver_bank.receiver_bank_f64(x, ent.reference_config(cfg, mix))
    assert got.shape == ref.shape == (16, 3 * N // 50)
    assert _worst_db(got, ref) <= _limit()


def test_three_blocks_equal_one_block_of_the_same_samples():
    """The carried state (input tail, phase index, discriminator sample,
    audio tails, de-emphasis) makes three blocks read as one; what differs
    is float32 rounding of the blocked sums, far under the cell's limit."""
    _, cfg, mix = _cell()
    mix3 = dict(mix, block_len=N, ring_blocks=3)
    ring = signals.make_ring(mix3, SEED + 1, "cpu")
    prog = _program(cfg, mix3)
    three = np.concatenate([prog(ring[g]).numpy() for g in range(3)], axis=1)
    one = _program(cfg, dict(mix, block_len=3 * N))(ring.reshape(-1)).numpy()
    assert _worst_db(three, one) < -120.0


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_left_out", "answer_altered"],
                         ids=["sound", "state_unchanged", "half_left_out", "answer_altered"])
def test_the_judge_passes_the_program_and_fails_its_faults(fault):
    """The cell's judge on blocks 1 and 2 of a ring of three: the sound
    program correct, each fault planted under it (bench_gpu/tests/faults.py:
    its state left unchanged, half the channels left out, one answer
    altered) not."""
    from bench_gpu.tests import faults
    c, cfg, mix = _cell()
    mix = dict(mix, block_len=N, ring_blocks=3)
    ring = signals.make_ring(mix, SEED + 3, "cpu")
    prog = _program(cfg, mix)
    if fault is not None:
        prog = getattr(faults, fault)(prog)
    outs = [prog(ring[g]) for g in range(3)]
    checks = registry.entry("receiver_bank").judge(cfg, c["params"], mix, ring, 1, outs[1:],
                                                   "cpu")
    assert [k["name"] for k in checks] == ["worst_ch_err_db"]
    assert checks[0]["ok"] == (fault is None), checks


@functools.lru_cache(maxsize=1)
def _control_readings():
    return calibrate.control_readings(CELL, SEED + 2, device="cpu", overrides=SMALL)


@pytest.mark.parametrize("i", range(len(CONTROLS)), ids=[c.name for c in CONTROLS])
def test_each_control_fails_the_cells_limit(i):
    r = _control_readings()[i]
    assert r["precision"] == CONTROLS[i].name
    assert r["checks"]["worst_ch_err_db"] > _limit(), r


def test_device_rounding_equals_the_controls_rounding():
    x = np.random.default_rng(5).standard_normal(4096) * 10.0 ** np.arange(-20, 21, 10)[
        np.arange(4096) % 5]
    for bits in (10, 7):
        np.testing.assert_array_equal(receiver_bank.round_bits(torch.tensor(x), bits).numpy(),
                                      precision.round_bits(x, bits))


def test_a_call_records_its_two_stages_and_its_step_once():
    _, cfg, mix = _cell()
    mix = dict(mix, block_len=5000, ring_blocks=1)
    prog = _program(cfg, mix)
    x = signals.make_ring(mix, SEED, "cpu")[0]
    reset_spans()
    try:
        with record_spans():
            prog(x)
        table = span_table()
    finally:
        reset_spans()
    assert {n: t["count"] for n, t in table.items()} == {
        "ReceiverBank.step": 1, "bank_step.channelize": 1, "bank_step.demod": 1}
    step = table["ReceiverBank.step"]
    inner = table["bank_step.channelize"]["total_ns"] + table["bank_step.demod"]["total_ns"]
    assert step["self_ns"] == step["total_ns"] - inner


def test_the_front_roofline_formula_at_the_cells_shape():
    """13.107 GFLOP (8 an output and tap, 128 taps, 16 x 800,000 outputs)
    and 166.4 MB, so 0.1956 ms bound by the operations (PERF.md's kernel
    table, row 3)."""
    m = registry.metric("halo_async_roofline")
    work = {"C": 16, "taps": 128, "N": 8_000_000, "nj": 800_000, "wire_bytes": 8}
    peaks = registry.peaks()
    assert m.OPS_PER_OUTPUT_TAP * 16 * 800_000 * 128 == pytest.approx(13.107e9, rel=1e-4)
    assert (8_000_000 + 127) * 8 + 16 * 800_000 * 8 == pytest.approx(166.4e6, rel=1e-4)
    assert m.least_s(work, peaks) * 1e3 == pytest.approx(0.1956, abs=5e-5)
    tr = {"counts_ok": True, "hand": {"halo_async": {"trace": 24, "seconds": 0.0}}}
    ctx = {"trace": tr, "work": {"halo_async": work}, "peaks": peaks, "blocks": 24}
    assert m.read(ctx) is None                        # no device time: no number
    tr["hand"]["halo_async"]["seconds"] = 24 * 2 * m.least_s(work, peaks)
    assert m.read(ctx) == pytest.approx(50.0)
    tr["counts_ok"] = False
    assert m.read(ctx) is None
