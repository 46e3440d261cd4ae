"""Quantizers (port of ``repro/quant``): PQ, the coarse VQ, k-means and the
codebook primitives. RQ (depth > 1) and OPQ wait for a later slice."""
from repro_torch.quant import base, codebook, kmeans  # noqa: F401
from repro_torch.quant.base import PQConfig  # noqa: F401
from repro_torch.quant.codebook import rotate_codebooks  # noqa: F401
from repro_torch.quant.pq import PQ  # noqa: F401
from repro_torch.quant.vq import VQ  # noqa: F401

RQ_LATER = ("depth > 1 (residual quantization, quant/rq.py) is not ported "
            "yet: ROADMAP.md queue 1, slice 6 'quant/rq.py'")


def fit_quantizer(generator, X, cfg: PQConfig, *, depth: int = 1,
                  iters: int = 10):
    """Fit the residual quantizer -> (PQ, distortion trace). Depth 1 only."""
    if depth > 1:
        raise NotImplementedError(RQ_LATER)
    return PQ.fit(generator, X, cfg, iters=iters)
