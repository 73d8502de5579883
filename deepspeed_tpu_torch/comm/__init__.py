from .comm import (CollectiveTimeoutError, ReduceOp, all_gather, all_reduce, all_to_all, axis_index, barrier,
                   bounded_collective, broadcast, configure, destroy_process_group, get_local_rank, get_rank,
                   get_world_size, host_all_reduce, host_broadcast, init_distributed, is_initialized,
                   log_summary, monitor_events, ppermute, reduce_scatter, set_default_collective_timeout,
                   set_init_retry_defaults)
from .groups import (ProcessGroup, get_data_parallel_group, get_expert_parallel_group,
                     get_model_parallel_group, get_pipe_parallel_group,
                     get_sequence_parallel_group, get_world_group, new_group)
