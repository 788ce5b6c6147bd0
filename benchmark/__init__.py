"""The benchmark of ``tianshou_tpu_torch`` on one NVIDIA H100: whole
``OffPolicyTrainer.run()`` windows, read through the trainer's public
arguments and hooks.  ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json``."""
