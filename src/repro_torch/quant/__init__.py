"""Quantizers (port of ``repro/quant``): PQ, the depth-M residual RQ, the
coarse VQ, k-means and the codebook primitives (``quant.opq`` is imported
on its own)."""
from repro_torch.quant import base, codebook, kmeans  # noqa: F401
from repro_torch.quant.base import PQConfig  # noqa: F401
from repro_torch.quant.codebook import rotate_codebooks  # noqa: F401
from repro_torch.quant.pq import PQ  # noqa: F401
from repro_torch.quant.rq import RQ  # noqa: F401
from repro_torch.quant.vq import VQ  # noqa: F401


def fit_quantizer(generator, X, cfg: PQConfig, *, depth: int = 1,
                  iters: int = 10):
    """Fit the residual family by depth: PQ at depth 1, RQ above ->
    (quantizer, distortion trace)."""
    if depth <= 1:
        return PQ.fit(generator, X, cfg, iters=iters)
    return RQ.fit(generator, X, cfg, depth, iters=iters)
