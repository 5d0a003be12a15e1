"""Fused kernels, the train step, data, sequence, pipeline, tensor and
expert parallelism over ``torch.distributed``, the run supervisor and the
asynchronous parameter service (port of ``incubator_mxnet_tpu/parallel``)."""
from . import (checkpoint, collectives, distributed, fault_injection,
               fused_bn, maxpool_idx, mesh, moe, param_service, pipeline,
               ring_attention, supervisor, train_step)
from .checkpoint import (CheckpointCorruptError, CheckpointError,
                         CheckpointManager, CheckpointTopologyError,
                         install_preemption_hook, request_checkpoint,
                         uninstall_preemption_hook)
from .flash_attention import flash_attention
from .mesh import Mesh, P, global_devices, make_mesh, spans_processes
from .moe import load_balancing_loss, moe_ffn, moe_ffn_sharded
from .param_service import (ParamService, ServiceClient, ServiceUpdater,
                            StalenessClock, StalenessTimeout, SyncPolicy)
from .pipeline import pipeline_apply, spmd_pipeline, stack_stage_params
from .supervisor import (DivergenceDetector, DivergenceError, HealthLedger,
                         HeartbeatEmitter, Supervisor, SupervisorConfig,
                         SupervisorError, run_supervised)
from .train_step import (DynamicLossScale, FunctionalOptimizer, TrainStep,
                         make_train_step)

__all__ = ["checkpoint", "collectives", "distributed", "fault_injection",
           "fused_bn", "maxpool_idx", "mesh", "moe", "param_service",
           "pipeline", "ring_attention", "supervisor", "train_step",
           "CheckpointCorruptError", "CheckpointError", "CheckpointManager",
           "CheckpointTopologyError", "install_preemption_hook",
           "request_checkpoint", "uninstall_preemption_hook",
           "flash_attention", "DynamicLossScale", "FunctionalOptimizer",
           "Mesh", "P", "TrainStep", "global_devices", "make_mesh",
           "make_train_step", "spans_processes",
           "load_balancing_loss", "moe_ffn", "moe_ffn_sharded",
           "pipeline_apply", "spmd_pipeline", "stack_stage_params",
           "DivergenceDetector", "DivergenceError", "HealthLedger",
           "HeartbeatEmitter", "Supervisor", "SupervisorConfig",
           "SupervisorError", "run_supervised", "ParamService",
           "ServiceClient", "ServiceUpdater", "StalenessClock",
           "StalenessTimeout", "SyncPolicy"]
