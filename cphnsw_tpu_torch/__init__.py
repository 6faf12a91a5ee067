"""cphnsw_tpu_torch: the CP-HNSW index in PyTorch + CUDA.

The PyTorch port of ``cphnsw_tpu`` for NVIDIA Hopper (H100).  It imports
torch and numpy only, never JAX.  Public API:

    CPIndex(dim, bits, device="cuda") . build / finalize / search /
    search_batch / save / load / size / dim / is_finalized
    ScanIndex(dim, bits, device="cuda")  -- the flat scan engine itself
    Index(dim, bits, r=32, device="cuda") -- the graph engine itself
        (NNDescent + alpha-CNG build, EVT-CRC calibration, DABS beam)

Index files are the JAX package's ``.npz`` format; each package loads the
other's files.
"""

from cphnsw_tpu_torch.api.index import CPIndex, Index
from cphnsw_tpu_torch.api.scan_index import ScanIndex

__all__ = ["CPIndex", "Index", "ScanIndex"]
__version__ = "0.1.0"
