"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``LAUNCHES`` counts kernel launches by kernel name. Each wrapper adds one
where it launches its CUDA kernel and nowhere else, so a run can show that
its main path went through the kernels: clear it, drive the path, read it.
``on_cpu`` is the wrappers' one choice between the two versions.
"""

from collections import Counter

LAUNCHES: Counter = Counter()


def on_cpu(op: str, *ts) -> bool:
    """True when every tensor lies on the CPU (the plain version runs),
    False when all lie on one CUDA device (the kernel runs); raises
    otherwise, naming ``op``."""
    if all(t.device.type == "cpu" for t in ts):
        return True
    if ts[0].device.type != "cuda" or any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{op}: inputs must share one CUDA device (or all lie on "
                         f"the CPU); got {[str(t.device) for t in ts]}")
    return False
