"""The benchmark of the PyTorch/CUDA port (tpu_breath_torch) on one NVIDIA
H100: `python -m breathbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON
line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in BENCHMARK.json:
- configs/<config>.json: the model's sizes, features and training
  hyperparameters as run; reference/<arch>.py is its plain reference;
- traffic/<mix>.json: the mix's parameters; its "kind" names the general
  generator under kinds/ that reads them (train, serve, score);
- limits/<cell>.json: the limit of each number the correctness check
  compares in that cell;
- metrics/<metric>.py: the reader of one per-layer metric.
The yardstick (data, reference, FLOP and byte counts, peaks, the trace
reduction) lives here too, so a change to the port cannot move it.
"""
