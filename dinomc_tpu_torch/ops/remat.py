"""Keep a kernel launch's outputs across a checkpointed block's recompute.

A block run under ``torch.utils.checkpoint`` (not reentrant; ``models/vit.py``
remat) is replayed in the backward to rebuild the tensors its backward
reads. A kernel launched from inside an ``autograd.Function`` (K1, K4) would
run again there. ``contexts()`` gives ``checkpoint``'s ``context_fn`` pair:
under the first, ``kept`` records what each launch returns; under the
second, the replay, ``kept`` hands the recorded outputs back, detached, in
the same order, and launches nothing. The Function around the launch still
runs in the replay, so it saves the same tensors as in the forward, which
``checkpoint`` requires. Outside both, ``kept`` just launches.
"""

from __future__ import annotations

import threading

_LOCAL = threading.local()  # autograd may replay a block on its own device thread


class _Record:
    """The outputs of one checkpointed block call's kept launches, in order;
    entered in the forward (``replaying`` False) or the replay (True)."""

    def __init__(self, outputs: list, replaying: bool):
        self.outputs, self.replaying, self.next = outputs, replaying, 0

    def __enter__(self):
        self.prev, self.next = getattr(_LOCAL, "record", None), 0
        _LOCAL.record = self
        return self

    def __exit__(self, *exc):
        _LOCAL.record = self.prev
        return False


def contexts():
    """(forward, replay) context managers for ``checkpoint``'s
    ``context_fn``, sharing one block call's record."""
    outputs: list = []
    return _Record(outputs, False), _Record(outputs, True)


def kept(launch, *args):
    """``launch(*args)`` (a tuple of tensors), recorded when a block's
    forward keeps it and handed back in that block's replay instead of
    launching again."""
    record = getattr(_LOCAL, "record", None)
    if record is None:
        return launch(*args)
    if record.replaying:
        out = record.outputs[record.next]
        record.next += 1
        return tuple(t.detach() for t in out)
    out = launch(*args)
    record.outputs.append(out)
    return out
