"""Named-axis mesh, collectives and decomposed collectives over
``torch.distributed`` (counterpart of ``deepspeed_tpu/comm``)."""

from .mesh import (MeshTopology, AXIS_ORDER, PIPE_AXIS, DATA_AXIS, FSDP_AXIS,
                   EXPERT_AXIS, SEQ_AXIS, TENSOR_AXIS, BATCH_AXES)
from .collectives import (Collectives, init_distributed, get_world_size,
                          get_rank, log_summary, lax_psum, lax_pmean,
                          lax_all_gather, lax_reduce_scatter, lax_all_to_all,
                          lax_ppermute)
from .comms_logging import comms_logger, CommsLogger, calc_bw_log
from .overlap import (ServingComm, overlapped_matmul_allreduce,
                      overlapped_matmul_allgather, overlapped_all_reduce,
                      overlapped_reduce_scatter, ring_all_gather,
                      ring_all_reduce, ring_reduce_scatter, wire_bytes)

__all__ = [
    "ServingComm", "overlapped_matmul_allreduce",
    "overlapped_matmul_allgather", "overlapped_all_reduce",
    "overlapped_reduce_scatter", "ring_all_gather", "ring_all_reduce",
    "ring_reduce_scatter", "wire_bytes",
    "MeshTopology", "AXIS_ORDER", "PIPE_AXIS", "DATA_AXIS", "FSDP_AXIS",
    "EXPERT_AXIS", "SEQ_AXIS", "TENSOR_AXIS", "BATCH_AXES",
    "Collectives", "init_distributed", "get_world_size", "get_rank",
    "log_summary", "lax_psum", "lax_pmean", "lax_all_gather",
    "lax_reduce_scatter", "lax_all_to_all", "lax_ppermute",
    "comms_logger", "CommsLogger", "calc_bw_log",
]
