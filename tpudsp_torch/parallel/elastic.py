"""Elastic recovery runner (port of ``tpudsp/parallel/elastic.py``).

Every chain state of the port is an explicit tree of tensors of a few KB,
so recovery is: snapshot the state every K blocks; on a failed step (a
lost card, a wedged transport, preemption), rebuild the chain and resume
from the last snapshot. At most K blocks are reprocessed, and the output
stream stays exact from the snapshot on. Snapshots go through the port's
``io/checkpoint`` (``save_state`` / ``load_state``), written to a
``.tmp.npz`` file and moved into place with ``os.replace``, so a crash
mid-write leaves the previous snapshot whole.
"""

from __future__ import annotations

import os
from typing import Callable

from ..io.checkpoint import load_state, save_state


class ElasticRunner:
    """A chain factory as a crash-resumable block processor.

    factory() -> an object with ``.state`` (a tree of tensors),
    ``.with_state(s)`` or a settable ``.state``, and ``__call__(block)``.
    Snapshots to ``path`` + ".npz" every ``snapshot_every`` blocks;
    ``resume()`` (or construction with an existing snapshot) restores the
    newest snapshot, onto the new chain's devices, and reports the block
    index to resume from.
    """

    def __init__(self, factory: Callable, path: str, snapshot_every: int = 16):
        self._factory = factory
        self._path = path
        self._every = int(snapshot_every)
        self.chain = factory()
        self.block_index = 0
        if os.path.exists(self._path + ".npz"):
            self.resume()

    def _set_state(self, state):
        if hasattr(self.chain, "with_state"):
            self.chain.with_state(state)
        else:
            self.chain.state = state

    def _get_state(self):
        return self.chain.state

    def snapshot(self):
        save_state(self._path + ".tmp.npz", {
            "state": self._get_state(), "block_index": self.block_index})
        os.replace(self._path + ".tmp.npz", self._path + ".npz")

    def resume(self) -> int:
        """Restore the newest snapshot; returns the block index to resume
        from (blocks >= this index must be fed again)."""
        like = {"state": self._get_state(), "block_index": 0}
        data = load_state(self._path + ".npz", like)
        self._set_state(data["state"])
        self.block_index = int(data["block_index"])
        return self.block_index

    def __call__(self, block):
        try:
            out = self.chain(block)
        except Exception:
            # a failed step: rebuild the chain and restore the newest
            # snapshot (or the fresh state if there is none yet), then
            # raise the ORIGINAL error; the caller replays from block_index
            self.chain = self._factory()
            if os.path.exists(self._path + ".npz"):
                self.resume()
            else:
                self.block_index = 0
            raise
        self.block_index += 1
        if self.block_index % self._every == 0:
            self.snapshot()
        return out
