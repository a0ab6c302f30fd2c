"""Fault handling of the port (counterpart of ``unicore_tpu/resilience``)."""

from .async_writer import AsyncCheckpointWriter, CheckpointWriteError  # noqa
from .preemption import ChildShutdown, GracefulShutdown  # noqa
from .watchdog import EXIT_CODE, StepWatchdog  # noqa
