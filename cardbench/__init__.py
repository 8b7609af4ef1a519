"""The benchmark of the PyTorch and CUDA port (``reservoir_tpu_torch``) on
one H100: ``python -m cardbench.run --workload <name> --seed <n> --seconds
<s> --trace <0|1>``.  See ``README.md`` beside this file."""
