"""Offline analysis of run logs (``log_parser``): the same seven names as
``mcmc_colorer_tpu.analysis``, without jax."""

from mcmc_colorer_tpu_torch.analysis.log_parser import (
    balance_index,
    count_non_convergent,
    parse_gpu_results_file,
    parse_log_file,
    parse_results_dir,
    per_iteration_speedups,
    speedups,
)

__all__ = [
    "balance_index",
    "count_non_convergent",
    "parse_gpu_results_file",
    "parse_log_file",
    "parse_results_dir",
    "per_iteration_speedups",
    "speedups",
]
