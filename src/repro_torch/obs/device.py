"""The device clock of obs spans on a CUDA card (``Recorder.device_clock``).

Each mark is a ``torch.cuda.Event(enable_timing=True)`` recorded on the
current stream, so it reads the time at which the device reached that
point of the stream, whatever the host was doing.  Recording one is
asynchronous; ``seconds`` is read only after ``synchronize()``.
"""

from __future__ import annotations

import torch


class CudaClock:
    """Marks on the current CUDA stream; ``epoch`` is the first, recorded
    when the clock is made."""

    def __init__(self) -> None:
        self.epoch = self.mark()

    @staticmethod
    def mark() -> torch.cuda.Event:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    @staticmethod
    def seconds(a: torch.cuda.Event, b: torch.cuda.Event) -> float:
        """Device seconds from mark ``a`` to mark ``b``."""
        return a.elapsed_time(b) * 1e-3

    @staticmethod
    def synchronize() -> None:
        torch.cuda.synchronize()
