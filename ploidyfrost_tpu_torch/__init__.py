"""ploidyfrost_tpu_torch — the PyTorch/CUDA port of the JAX package
(ploidyfrost_tpu/).

The single-sample and the multi-sample (colored) pipeline (reads ->
k-mer counting -> cutoffs -> compacted, optionally colored, de Bruijn
graph -> superbubbles -> branch alignment -> sites -> GMM-EM ploidy
call) on an NVIDIA GPU, with their stage subcommands, the KMC and
Bifrost file formats and the post-processing layer (filter.py,
figures.py). Four loops run on the card as hand-written CUDA kernels
(csrc/, built with nvcc at first use): canonical k-mer extraction
(extract_canonical.cu), the superbubble search (superbubble_search.cu),
the whole EM loop of a GMM fit (gmm_em.cu) and, when the native NW
library is missing, the NW flag wavefront (nw_wavefront.cu). The
counter's sort-collapse and, on request, the link sort of graph
construction are torch ops on the chosen device; graph construction,
coloring, alignment and table output are host code (numpy and native
C++). On several GPUs (`--devices`, parallel/) one rank a card shares
the counting, the superbubble search and the EM over torch.distributed.

This package never imports jax or the JAX package. Entry points take a
``device`` argument (default ``"cuda"``) and raise when CUDA is asked
for and absent: nothing silently runs on the CPU. Pass ``device="cpu"``
to run the plain torch versions on the host (the tests do).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for ``device``; raises RuntimeError when a CUDA
    device is asked for and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
