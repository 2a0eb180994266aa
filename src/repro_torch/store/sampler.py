"""Window-shuffle streaming sampler for storage-backed corpora.

A global Fisher–Yates shuffle needs the whole index (and, for true
random reads over sharded storage, defeats sequential prefetch). The
streaming compromise — grain/tf.data's ``shuffle(window)`` — keeps a
W-item reservoir: fill the window from the sequential cursor, emit a
uniformly-drawn member, backfill from the cursor, repeat. ``window=1``
degenerates to sequential order; ``window>=n`` to a full uniform
shuffle.

Determinism contract (the same one ``DataLoader._epoch_order`` already
obeys): the emission order is a **pure function of (seed, epoch)** —
``window_shuffle_order(n, seed, epoch, window)`` materializes it, and
the streaming ``WindowShuffleSampler`` replays it incrementally. State
is therefore three integers ``(seed, epoch, cursor)`` (+ the static
``n``/``window``); it round-trips through ``checkpoint.manager`` extras
and ``restore()`` resumes mid-epoch exactly, by replaying the RNG draws
up to the cursor — O(cursor) integer work, zero corpus IO.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _rng(seed: int, epoch: int) -> np.random.RandomState:
    return np.random.RandomState([0x5A17, seed, epoch])


def window_shuffle_order(n: int, seed: int, epoch: int,
                         window: int) -> np.ndarray:
    """The full epoch-emission order as a permutation of ``range(n)`` —
    a pure function of (seed, epoch)."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    rng = _rng(seed, epoch)
    out = np.empty(n, np.int64)
    buf = list(range(min(window, n)))
    nxt = len(buf)
    for k in range(n):
        r = rng.randint(len(buf))
        out[k] = buf[r]
        if nxt < n:
            buf[r] = nxt
            nxt += 1
        else:
            buf[r] = buf[-1]
            buf.pop()
    return out


class WindowShuffleSampler:
    """Streaming index sampler over a corpus of ``n`` records.

    Iterating yields indices forever, auto-advancing epochs; ``state()``
    / ``restore()`` give exact-resume checkpointing. The reservoir is
    rebuilt on restore by replaying the epoch's draws, so state stays
    three integers instead of a pickled buffer.
    """

    def __init__(self, n: int, *, seed: int = 0, window: int = 64):
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.n = n
        self.seed = seed
        self.window = window
        self.epoch = 0
        self.cursor = 0                  # indices emitted this epoch
        self._enter_epoch()

    # -- the state machine --------------------------------------------
    def _enter_epoch(self) -> None:
        self._rng = _rng(self.seed, self.epoch)
        self._buf = list(range(min(self.window, self.n)))
        self._next = len(self._buf)

    def _draw(self) -> int:
        r = self._rng.randint(len(self._buf))
        out = self._buf[r]
        if self._next < self.n:
            self._buf[r] = self._next
            self._next += 1
        else:
            self._buf[r] = self._buf[-1]
            self._buf.pop()
        return out

    def __iter__(self) -> "WindowShuffleSampler":
        return self

    def __next__(self) -> int:
        if self.n == 0:
            raise StopIteration
        if self.cursor == self.n:        # epoch boundary: new permutation
            self.epoch += 1
            self.cursor = 0
            self._enter_epoch()
        self.cursor += 1
        return self._draw()

    # -- checkpointing -------------------------------------------------
    def state(self) -> Dict[str, int]:
        """msgpack/JSON-safe snapshot: plain ints only."""
        return {"n": self.n, "seed": self.seed, "window": self.window,
                "epoch": self.epoch, "cursor": self.cursor}

    def restore(self, state: Dict[str, int]) -> None:
        if int(state["n"]) != self.n or int(state["window"]) != self.window:
            raise ValueError(
                f"sampler shape mismatch: checkpoint has n={state['n']} "
                f"window={state['window']}, sampler has n={self.n} "
                f"window={self.window}")
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])
        self.cursor = int(state["cursor"])
        self._enter_epoch()
        for _ in range(self.cursor):     # replay draws; no corpus IO
            self._draw()
