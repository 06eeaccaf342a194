"""The benchmark of the PyTorch and CUDA port (`peppa_tpu_torch`).

`python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on the card and
prints one JSON line.  See `benchmark/run.py`.
"""
