"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds one
where it launches its CUDA kernel and nowhere else, so a run can show that
its main path went through the kernels: clear it, drive the path, read it.
"""

from collections import Counter

LAUNCHES: Counter = Counter()
