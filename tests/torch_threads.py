"""One torch thread in each test process.

pytest-xdist runs the suite in several worker processes on the machine's
cores, and torch's default of one intra-op thread a core in every worker
oversubscribes them: the port's tests ran about three times slower under
`-n 6`.  Every `tests/test_torch_*.py` imports this module first.
"""

import torch

torch.set_num_threads(1)
