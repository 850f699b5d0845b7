"""Partitioned storage: which device owns which partition, and the read path.

The port's copy of the core of ``repro.data.storage.PartitionedStore``: a
partition lives on exactly one storage device (round-robin ownership), and
``read`` regenerates it from the synthetic source and charges its stored
bytes.  Device fleets, fault injection, partition files and cache spill are
not carried yet.
"""

from __future__ import annotations

import threading
from typing import List

from repro_torch.data.columnar import Partition
from repro_torch.data.synth import SyntheticRecSysSource


class PartitionedStore:
    def __init__(
        self, num_partitions: int, num_devices: int, source: SyntheticRecSysSource
    ):
        if num_partitions < 1 or num_devices < 1:
            raise ValueError(
                f"num_partitions={num_partitions} and num_devices={num_devices} "
                "must be >= 1"
            )
        self.num_partitions = num_partitions
        self.num_devices = num_devices
        self.source = source
        self._read_bytes = 0
        self._lock = threading.Lock()  # reads may come from a staging thread

    def owner_of(self, partition_id: int) -> int:
        """Storage device that holds this partition (round-robin)."""
        return partition_id % self.num_devices

    def partitions_of(self, device: int) -> List[int]:
        return [
            pid for pid in range(self.num_partitions) if self.owner_of(pid) == device
        ]

    def read(self, partition_id: int) -> Partition:
        """Fetch one partition off its owning device and charge its bytes."""
        if not 0 <= partition_id < self.num_partitions:
            raise IndexError(
                f"partition {partition_id} outside [0, {self.num_partitions})"
            )
        part = self.source.partition(partition_id)
        with self._lock:
            self._read_bytes += part.nbytes()
        return part

    @property
    def bytes_read(self) -> int:
        with self._lock:
            return self._read_bytes
