"""The benchmark of the PyTorch and CUDA port (``pautdx_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; see ``README.md``.
"""
