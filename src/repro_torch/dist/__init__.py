"""The multi-host layer (port of ``repro.dist``).

* :mod:`repro_torch.dist.sharding` — the spec trees of params and batches
  (TP over ``model``, optional FSDP over ``data``) and one rank's
  ``Placement`` of a train state over a ``DeviceMesh``;
* :mod:`repro_torch.dist.overlap` — the ring all-reduce (sum, mean, min)
  and the port's other collectives over a ``torch.distributed`` group
  (gloo, CUDA tensors through host memory);
* :mod:`repro_torch.dist.straggler` — ``StepWatchdog`` and
  ``HeartbeatFile``;
* :mod:`repro_torch.dist.mvgc` — the sharded MVGC stack: one paged-KV
  shard per host, the hosts spread over a mesh's ranks, global-LWM
  reclamation over the ``reduce="min"`` ring and straggler-tolerant
  announcement aging (DESIGN.md §13).
"""
from repro_torch.dist.mvgc import (ShardedPagedKVEngine, age_out_stale,
                                   global_lwm, lwm_contributions,
                                   stack_states)
from repro_torch.dist.overlap import ring_all_reduce
from repro_torch.dist.sharding import (batch_sharding, batch_spec,
                                       host_stacked_sharding,
                                       param_shardings)
from repro_torch.dist.straggler import HeartbeatFile, StepWatchdog

__all__ = [
    "batch_sharding",
    "batch_spec",
    "host_stacked_sharding",
    "param_shardings",
    "ring_all_reduce",
    "StepWatchdog",
    "HeartbeatFile",
    "ShardedPagedKVEngine",
    "stack_states",
    "lwm_contributions",
    "age_out_stale",
    "global_lwm",
]
