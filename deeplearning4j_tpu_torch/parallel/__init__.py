"""Device meshes and the decoder's partition specs, data-parallel
training (sync and local-steps ``ParallelWrapper``, the graph trainer,
the parameter servers, multi-process averaging and checkpoints; batch
norms and center losses over the global batch through the
vertex-synchronous sharded walk), tensor, pipeline, expert and sequence
parallelism (ring attention), serving lifecycle errors, fault injection,
supervised restart, the preemption drains and parallel inference."""

from .early_stopping_parallel import EarlyStoppingParallelTrainer
from .expert import (ExpertParallelTrainer, MixtureOfExpertsLayer,
                     ep_param_specs)
from .failures import (EngineSupervisor, HeartbeatMonitor,
                       PreemptionHandler, WorkerLostError, run_elastic)
from .faults import (NULL_INJECTOR, Cancelled, DeadlineExceeded,
                     FaultInjector, RejectedError)
from .graph_wrapper import GraphDataParallelTrainer
from .inference import InferenceMode, ParallelInference
from .magic_queue import MagicQueue
from .mesh import (Mesh, P, ShardedTensor, batch_sharded, generation_mesh,
                   make_mesh, mesh_axis_sizes, mesh_tag, parse_mesh_shape,
                   replicated, shard_batch_spec, validate_decode_mesh)
from .pipeline import PipelineParallelTrainer, pipeline_apply
from .param_server import (InMemoryParameterServer, ParameterServerClient,
                           ParameterServerNode,
                           ParameterServerParallelWrapper,
                           ParameterServerTrainer)
# the SERVING drain handler, exported under a distinct name as in the JAX
# package: failures.PreemptionHandler (training checkpoint-on-SIGTERM)
# keeps its name
from .preemption import DrainReport
from .preemption import PreemptionHandler as ServingPreemptionHandler
from .sequence import (GraphSequenceParallelTrainer,
                       SequenceParallelTrainer, attention_reference,
                       disable_ring_attention, enable_ring_attention,
                       ring_self_attention, sequence_sharded)
from .spec_layout import (SpecLayout, decoder_param_specs, param_shardings,
                          shard_params, validate_param_specs)
from .tensor import ShardedTrainer, TensorParallelTrainer, tp_param_specs
from .wrapper import ParallelWrapper

__all__ = ["Cancelled", "DeadlineExceeded", "DrainReport",
           "EarlyStoppingParallelTrainer", "EngineSupervisor",
           "ExpertParallelTrainer", "FaultInjector",
           "GraphDataParallelTrainer", "GraphSequenceParallelTrainer",
           "HeartbeatMonitor", "MixtureOfExpertsLayer",
           "PipelineParallelTrainer", "SequenceParallelTrainer",
           "ShardedTrainer", "TensorParallelTrainer",
           "attention_reference", "disable_ring_attention",
           "enable_ring_attention", "ep_param_specs", "pipeline_apply",
           "ring_self_attention", "sequence_sharded", "tp_param_specs",
           "InMemoryParameterServer", "InferenceMode", "MagicQueue", "Mesh",
           "NULL_INJECTOR", "P", "ParallelInference", "ParallelWrapper",
           "ParameterServerClient", "ParameterServerNode",
           "ParameterServerParallelWrapper", "ParameterServerTrainer",
           "PreemptionHandler", "RejectedError",
           "ServingPreemptionHandler", "ShardedTensor", "SpecLayout",
           "WorkerLostError", "batch_sharded", "decoder_param_specs",
           "generation_mesh", "make_mesh", "mesh_axis_sizes", "mesh_tag",
           "param_shardings", "parse_mesh_shape", "replicated",
           "run_elastic", "shard_batch_spec", "shard_params",
           "validate_decode_mesh", "validate_param_specs"]
