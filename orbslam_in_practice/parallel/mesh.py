"""Mesh construction + multi-host runtime bring-up.

The reference has no distributed anything (SURVEY.md §2.3).
jax.distributed.initialize brings up the multi-host runtime; the Mesh is a
flat 1-D axis over the device list, and XLA hands its collectives to NCCL.
The GPUs of one host are joined all to all by NVLink, so every device
reaches every other at the same rate and the mesh follows the algorithm
(landmark blocks) alone, with no topology in it.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def initialize_multihost(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Bring up the multi-host runtime (no-op when single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(n_devices: int | None = None, axis: str = "d") -> Mesh:
    """1-D landmark-sharding mesh over the first n devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))
