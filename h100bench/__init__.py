"""The benchmark of ``sdfa_tpu_torch`` on the H100: ``python h100bench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` from the root of a
checkout. ``BENCHMARK.json`` names the cells; each configuration, traffic mix,
per-layer metric and limit table is a file of its own here, found by name.
Nothing here imports JAX or the JAX package; ``reference/`` imports nothing of
the port either."""
