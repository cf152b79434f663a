"""The benchmark of ``mcmc_colorer_tpu_torch``: closed loops of colouring
jobs on one card.  ``python3 -m colorbench.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``; see README.md."""
