"""One torch intra-op thread in every process of the port's tests.

The tests run in several pytest-xdist workers at once on one host. With
torch's default of one OpenMP thread a core in each worker, the host's cores
are oversubscribed several times over, and the many small ops of the plain
versions and the fixtures wait on each other's threads: six copies of
`torch_kernel_cases.decode_rows("48k_160k")` at once took more than 900 s at
8 threads on 8 cores and 7 s at 1. Every tests/test_torch_*.py imports this
module, through tests/torch_port_data.py, tests/torch_kernel_cases.py or
directly. XLA's threads are left as they are.
"""
import torch

torch.set_num_threads(1)
