"""Device meshes and the decoder's partition specs, serving lifecycle
errors, fault injection, supervised restart, the preemption drains and
parallel inference."""

from .failures import (EngineSupervisor, HeartbeatMonitor,
                       PreemptionHandler, WorkerLostError, run_elastic)
from .faults import (NULL_INJECTOR, Cancelled, DeadlineExceeded,
                     FaultInjector, RejectedError)
from .inference import InferenceMode, ParallelInference
from .mesh import (Mesh, P, ShardedTensor, batch_sharded, generation_mesh,
                   make_mesh, mesh_axis_sizes, mesh_tag, parse_mesh_shape,
                   replicated, shard_batch_spec, validate_decode_mesh)
# the SERVING drain handler, exported under a distinct name as in the JAX
# package: failures.PreemptionHandler (training checkpoint-on-SIGTERM)
# keeps its name
from .preemption import DrainReport
from .preemption import PreemptionHandler as ServingPreemptionHandler
from .spec_layout import (SpecLayout, decoder_param_specs, param_shardings,
                          shard_params, validate_param_specs)

__all__ = ["Cancelled", "DeadlineExceeded", "DrainReport",
           "EngineSupervisor", "FaultInjector", "HeartbeatMonitor",
           "InferenceMode", "Mesh", "NULL_INJECTOR", "P",
           "ParallelInference", "PreemptionHandler", "RejectedError",
           "ServingPreemptionHandler", "ShardedTensor", "SpecLayout",
           "WorkerLostError", "batch_sharded", "decoder_param_specs",
           "generation_mesh", "make_mesh", "mesh_axis_sizes", "mesh_tag",
           "param_shardings", "parse_mesh_shape", "replicated",
           "run_elastic", "shard_batch_spec", "shard_params",
           "validate_decode_mesh", "validate_param_specs"]
