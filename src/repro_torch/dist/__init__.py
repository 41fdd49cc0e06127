"""The multi-host layer (port of ``repro.dist``).

* :mod:`repro_torch.dist.mvgc` — the sharded MVGC stack: one paged-KV
  shard per host, global-LWM reclamation and straggler-tolerant
  announcement aging (DESIGN.md §13);
* :mod:`repro_torch.dist.overlap` — the ring all-reduce (sum, mean, min)
  over a ``torch.distributed`` group, in JAX's hop order;
* :mod:`repro_torch.dist.straggler` — ``StepWatchdog`` and
  ``HeartbeatFile``.

The training shardings of ``repro.dist.sharding`` are not ported.
"""
from repro_torch.dist.mvgc import (ShardedPagedKVEngine, age_out_stale,
                                   global_lwm, lwm_contributions,
                                   stack_states)
from repro_torch.dist.overlap import ring_all_reduce
from repro_torch.dist.straggler import HeartbeatFile, StepWatchdog

__all__ = [
    "ShardedPagedKVEngine",
    "stack_states",
    "lwm_contributions",
    "age_out_stale",
    "global_lwm",
    "ring_all_reduce",
    "StepWatchdog",
    "HeartbeatFile",
]
