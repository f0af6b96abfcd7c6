"""Multi-host (multi-process) distributed backend: the host axis.

The reference scales past one machine by running one process per cell
and wiring them at the application layer (lib/src/radio/radio_multi.cc
one-PHY-per-carrier; srsenb/srsepc as separate hosts over S1). The
batched equivalent is a ``host`` mesh axis in front of the
single-process (carrier, sf) axes: ``jax.distributed`` forms the
process group, every process contributes its local devices, and
collectives that cross the host axis go over the network between hosts
while carrier/sf-axis collectives stay within one host.

Validation without multi-host hardware: ``tools/multihost_dryrun.py``
launches N real OS processes on virtual CPU devices, builds the global
(host, carrier, sf) mesh here, and runs (a) the full no-genie ue_dl
chain sharded over all three axes with a cross-host psum and (b) the
trellis-sharded NII turbo decode with its ppermute boundary exchange
crossing the host axis — the cross-process analog of the evidence the
single-process dryrun provides.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None) -> None:
    """Join the process group (jax.distributed.initialize passthrough).

    Pass the coordinator address, process count and process id
    explicitly (the CPU dryrun does).
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def make_global_mesh(carriers: int = 1) -> Mesh:
    """Build the (host, carrier, sf) mesh over every process's devices.

    The leading ``host`` axis maps 1:1 onto processes (asserted), so a
    collective over 'host' is by construction a cross-process
    collective and collectives over 'carrier'/'sf' stay within one
    process's devices.
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_host = jax.process_count()
    assert len(devs) % n_host == 0, (len(devs), n_host)
    per_host = len(devs) // n_host
    assert per_host % carriers == 0, (per_host, carriers)
    sf = per_host // carriers
    arr = np.asarray(devs).reshape(n_host, carriers, sf)
    # collective-boundary assertion: the host axis crosses processes,
    # the carrier/sf axes do not
    for h in range(n_host):
        procs = {d.process_index for d in arr[h].ravel()}
        assert procs == {arr[h, 0, 0].process_index}, (
            f"host axis row {h} spans processes {procs}")
    return Mesh(arr, axis_names=("host", "carrier", "sf"))
