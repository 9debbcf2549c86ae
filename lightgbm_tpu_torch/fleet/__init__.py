"""The elastic training fleet (counterpart of lightgbm_tpu/fleet/).

``task=train tpu_fleet=N`` gang-launches N ranks (``launch.py``), which
meet over a shared directory, swap binned row shards over the host-TCP
transport (``transport.py``), or over a ``torch.distributed`` group where
CUDA is present, send a heartbeat on the fingerprint cadence
(``health.py``), and survive losing a rank by rolling back to the newest
common checkpoint and resuming at the shrunk (or healed) world size
(``elastic.py``).
"""
from .health import FleetHeartbeatCallback, FleetSession, make_heartbeat
from .launch import (FleetSettings, device_collective_support, launch_fleet,
                     resolve_fleet, should_gang_launch)
from .transport import (FleetClient, FleetCoordinatorLost, FleetError,
                        FleetHub, FleetPeerLost, FleetResize,
                        HostCollectives)
from .elastic import run_host_rank, run_rank

__all__ = [
    "FleetClient", "FleetCoordinatorLost", "FleetError", "FleetHub",
    "FleetHeartbeatCallback", "FleetPeerLost", "FleetResize",
    "FleetSession", "FleetSettings", "HostCollectives",
    "device_collective_support", "launch_fleet", "make_heartbeat",
    "resolve_fleet", "run_host_rank", "run_rank", "should_gang_launch",
]
