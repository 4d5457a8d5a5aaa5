"""The port's CPU tests run torch on one intra-op thread.

The plain path runs thousands of ops on tiny tensors: an intra-op thread
pool only adds overhead, and with several test workers it oversubscribes
the host (a 2-tile shared-L2 run takes 16.5 s on one thread, 88 s on
eight).  Each `tests/test_torch_*.py` imports this module, directly or
through a port test module it imports.
"""

import torch

torch.set_num_threads(1)
