"""One intra-op PyTorch thread per test process.

The tier-1 command runs the suite in six pytest-xdist workers on an
8-core machine, and each PyTorch process starts one OpenMP intra-op thread
per core by default: six workers of eight spinning threads each contend
for the cores. On the port's six slowest files, in six workers, one thread
took their summed test time from 1945.8 s to 589.0 s and their wall time
from 491 s to 198 s on an 8-core CPU machine. pytest imports every test
module of a run before its first test starts, so this import sets the count for
every test of the worker; the multi-rank tests' spawned ranks set it
themselves (test_torch_parallel_ranks.py).
"""

import torch

torch.set_num_threads(1)


def test_one_intra_op_thread():
    assert torch.get_num_threads() == 1
