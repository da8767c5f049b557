"""The benchmark of dpsvm_tpu_torch: one command, cells found by name.

``python benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA card.
Nothing here imports the JAX package; ``reference/`` imports nothing of
the port either.
"""
