"""The benchmark of the PyTorch and CUDA port ``ekf_slam_tpu_torch`` on
one NVIDIA H100: ``python benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the checkout's root."""
