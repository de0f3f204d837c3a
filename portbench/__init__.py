"""The benchmark of ``omnia_tpu_torch``: serving cells on the H100.

See ``portbench/README.md``; one cell runs as ``python3 portbench/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>``.
"""
