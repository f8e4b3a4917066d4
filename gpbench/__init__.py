"""The benchmark of the PyTorch / CUDA port (``repro_torch``): run one cell
with ``python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``."""
