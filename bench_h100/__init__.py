"""The benchmark of the PyTorch and CUDA port (``jittor_mlp_tpu_torch``) on
one H100: ``python3 bench_h100/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See README.md."""
