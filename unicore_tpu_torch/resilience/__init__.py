"""Fault handling of the port (counterpart of ``unicore_tpu/resilience``):
the in-step anomaly guard and its escalation ladder, the last-good
snapshot ring, the trajectory file, the background checkpoint writer,
graceful shutdown and the step watchdog."""

from .anomaly import (GUARD_CARRY_KEYS, AnomalyGuardConfig,  # noqa: F401
                      EscalationPolicy, guard_init, guard_update)
from .async_writer import AsyncCheckpointWriter, CheckpointWriteError  # noqa
from .preemption import ChildShutdown, GracefulShutdown  # noqa
from .snapshot import SnapshotRing, restore_state, snapshot_state  # noqa
from .trajectory import TrajectoryWriter, read_trajectory  # noqa: F401
from .watchdog import EXIT_CODE, StepWatchdog  # noqa
