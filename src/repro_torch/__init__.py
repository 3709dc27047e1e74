"""PyTorch port of the ``repro`` serving path for NVIDIA Hopper.

The package mirrors ``repro``'s module names and layout so that each
function has an obvious counterpart.  It imports ``torch`` only: nothing of
JAX and nothing of ``repro`` (it keeps its own copies of the configuration,
allocator, scheduler and telemetry code it needs).  Entry points run on
``cuda`` unless a caller passes ``device="cpu"``; on the CPU every kernel
wrapper runs its plain PyTorch version.
"""

from .device import resolve_device
