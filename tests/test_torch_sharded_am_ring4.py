"""The port's time-sharded AM receiver on a ring of four spawned gloo ranks
(halo='ppermute', c64, two blocks): against the JAX package's receiver,
and as it ships against the float64 oracle chain, both from one spawn.
The helpers, the bars and the entry-power swap are
tests/test_torch_sharded_am.py's; the case lives in a file of its own so
that each file's run stays short."""

import pytest

from tests.test_torch_sharded_am import (PCM_LOC, check_pcm, jax_run,
                                         make_blocks, oracle, ring_pcm)
from tests.util import snr_db


@pytest.fixture(scope="module")
def ring4(tmp_path_factory):
    """The JAX pcm, the port's with JAX's powers, and the port's as it
    ships, on the same c64 blocks."""
    blocks = make_blocks(4, "c64")
    carried, y_jax = jax_run(4, "ppermute", "c64", blocks)
    port = ring_pcm(tmp_path_factory.mktemp("ring4"), 4, {
        "pcm": ("ppermute", "c64", carried, blocks, True),
        "shipped": ("ppermute", "c64", None, blocks, False)})
    return blocks, y_jax, port


def test_port_matches_jax_sharded_am_ring4(ring4):
    _, y_jax, port = ring4
    check_pcm(port["pcm"], y_jax, 4, "c64")


def test_port_against_oracle_chain_ring4(ring4):
    """The shipped port (float64-rounded entry powers) on the ring of four
    against the float64 oracle chain past the first block's settling
    half: >= 100 dB, and above the JAX receiver."""
    blocks, y_jax, port = ring4
    y_ref, settle = oracle(blocks), PCM_LOC * 4 // 2
    s = check_pcm(port["shipped"], y_ref, 4, "c64", settle=settle)
    s_jax = snr_db(y_ref[settle:], y_jax[settle:])
    print(f"T=4 JAX receiver: {s_jax:.2f} dB")
    assert s > s_jax
