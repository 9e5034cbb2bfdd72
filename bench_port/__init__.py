"""The benchmark of crackle_tpu_torch on the H100: one cell a run,
`python3 bench_port/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>` from the root of a checkout."""
