"""Where the port's entry points run: the card, unless the caller asks
for the CPU.

``current_device()`` is ``cuda:0`` by default and raises when there is
no card — a decode that silently fell back to the CPU would read as a
card measurement. ``use_device("cpu")`` (a context manager, scoped to
the calling thread's context) and ``set_device("cpu")`` (process-wide)
are how tests and CPU-only callers ask for the CPU explicitly. Both
read a bare ``cuda`` as ``cuda:0``, the card that tensors made there
land on. ``add_device_flag``, ``entry_device`` and ``on_device`` are
the ``--device`` flag and guard that the port's entry points share.
"""
from __future__ import annotations

import argparse
import contextlib
import contextvars
import sys
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device]

_DEFAULT = torch.device("cuda", 0)
_PROCESS_DEVICE: Optional[torch.device] = None
_SCOPED: contextvars.ContextVar[Optional[torch.device]] = \
    contextvars.ContextVar("repro_torch_device", default=None)


def _as_device(device: DeviceLike) -> torch.device:
    # a bare "cuda" is the default card: parameters made under it sit on
    # cuda:0, and a check against the selected device must see the same
    dev = torch.device(device)
    return _DEFAULT if dev.type == "cuda" and dev.index is None else dev


def set_device(device: Optional[DeviceLike]) -> None:
    """Process-wide device for every later call (``None`` restores the
    ``cuda:0`` default). A ``use_device`` scope still overrides it."""
    global _PROCESS_DEVICE
    _PROCESS_DEVICE = None if device is None else _as_device(device)


@contextlib.contextmanager
def use_device(device: DeviceLike) -> Iterator[torch.device]:
    """Run the enclosed calls on ``device`` (e.g. ``"cpu"``)."""
    dev = _as_device(device)
    token = _SCOPED.set(dev)
    try:
        yield dev
    finally:
        _SCOPED.reset(token)


def selected_device() -> torch.device:
    """The device the calling context has selected, unchecked: the
    innermost ``use_device`` scope, else ``set_device``'s, else ``cuda:0``.

    A ``use_device`` scope does not reach threads started inside it (a
    new thread starts with an empty context), so code that hands work to
    its own threads reads this once and re-enters it there."""
    return _SCOPED.get() or _PROCESS_DEVICE or _DEFAULT


def current_device() -> torch.device:
    """The device the port's entry points run on.

    Raises ``RuntimeError`` when that is a CUDA device and no card is
    visible: the CPU is used only when it was asked for."""
    dev = selected_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"repro_torch runs on {dev} but no CUDA card is visible "
            "(torch.cuda.is_available() is False); pass "
            "use_device('cpu') or set_device('cpu') to run on the CPU")
    return dev


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    """The entry points' ``--device`` flag: the card unless it says
    ``cpu``."""
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")


def entry_device(name: DeviceLike) -> Optional[torch.device]:
    """The device an entry point's ``--device`` names, checked: ``None``,
    after saying why on stderr, when that is the card and none is
    visible. The entry point then exits 2 rather than run on the CPU."""
    with use_device(name):
        try:
            return current_device()
        except RuntimeError as e:
            print(f"error: {e} (here: --device cpu)", file=sys.stderr)
            return None


@contextlib.contextmanager
def on_device(name: DeviceLike) -> Iterator[torch.device]:
    """An entry point's body on ``name``; ``SystemExit(2)`` where
    ``entry_device`` finds no card."""
    dev = entry_device(name)
    if dev is None:
        raise SystemExit(2)
    with use_device(dev):
        yield dev
