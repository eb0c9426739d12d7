"""Parallel runs of the port over `torch.distributed` (JAX package
`parallel/`): one process a rank, started by a launcher (`torchrun`) or by
`launch.run_ranks`.

- `mesh`: the process group from the launcher's environment, the backend
  rule, and an (snr, dp) layout of the ranks with a group for each axis;
- `batch`: a rank's share of a data-parallel batch, the draws of the global
  batch and the collectives that make batch-wide statistics global;
- `sharding`: the data-parallel train steps and the SNR-sharded sweeps;
- `launch`: spawn the ranks of a group on one host and collect what each
  returns.

The modules are imported by name (this file imports none of them: the
models import `batch`, and `sharding` imports the models).
"""
