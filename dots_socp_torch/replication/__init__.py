"""The replication harness on the port (counterpart of the repository's
`replication/` folder, which drives the JAX package):

    python -m dots_socp_torch.replication.main --example=plane --n_space=24 ...
    python -m dots_socp_torch.replication.main_versus_exact --example=plane ...
    python -m dots_socp_torch.replication.sweep --examples ring hills ...
    python -m dots_socp_torch.replication.log2table -i info.log -o t.tex t.html

Each also runs by its path from any working directory. Every solve runs on
`--device` (default cuda) through the port's solver.
"""
