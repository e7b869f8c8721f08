"""The benchmark of fedrann_tpu_torch, the PyTorch and CUDA port: one
search job (`pipeline.search`) over read sets made on the card from a
seed, timed over a fixed window and judged against a plain reference.
`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json."""
