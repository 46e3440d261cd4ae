"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``src/repro`` module for module, so each port module
has a counterpart of the same name there. The JAX package is the reference;
this one imports only ``torch``, numpy and the standard library.

Device rule: the device of the tensors decides. A CPU tensor goes to the
plain PyTorch version of a kernel; a CUDA tensor goes to the hand-written
Hopper kernel (``kernels/csrc``), or the call raises. Entry points that
create state (``search.make(...).build``, ``data.synthetic``,
``rotations`` ``init``, ``models.recsys.TwoTower.init``,
``models.transformer.init_params`` and ``init_cache``, ``convert``) take
``device=`` with the card as the default and raise when no card is present
unless ``device="cpu"`` is passed.

Five slices are ported. Serving: an IVF-PQ index on a rotation learned by
Givens coordinate descent (``rotations``, ``quant``, ``index``, ``search``).
Training: the paper's two-tower model trained through the trainable PQ
index layer T(X) = φ(XR)Rᵀ with R moved by GCD (``models``,
``core.index_layer``, ``training``, ``quant.opq``, ``configs``). The
serving front end: ``search.Engine`` (ragged batches, the per-query LUT
cache, live refresh) over fused-refresh states, whose tables the
``fused_lut`` kernel builds, the exact backends as the recall oracle, and
``obs`` (metrics, spans, the recall probe). LM serving with a
PQ-compressed KV cache: prefill and decode of the dense LM configs
(``models.transformer``, ``models.layers``, ``core.kv_quant``,
``configs.get``), the cache scored by the ``adc_batch`` kernel. Live
churn on a single device: staged adds served by an ``adc_lookup`` side
pass, tombstones, flush, compaction in the foreground or on a worker
thread, and per-row staleness (``churn``). The multi-tenant serving
front end over the Engine: continuous batching, SLO-adaptive nprobe and
namespaces sharing one LUT budget (``serve``), with the BENCH trajectory
writer (``obs.write_bench``). See ROADMAP.md for what is still to be
ported.
"""
